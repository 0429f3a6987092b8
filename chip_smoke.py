#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (dynamo_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the run exits non-zero:

1. Card: torch version, device name, nvidia-smi's name and power limit.
2. Build: every kernel under dynamo_tpu_torch/ops/csrc with nvcc
   (sm_90a) into build/kernels/, timed.
3. Kernel parity and timing at the main path's shapes (llama-8b decode
   geometry: B=8, KVH=8, G=4, hd=128, bs=16), every mode of the paged
   attention kernel against its plain PyTorch version on the same CUDA
   tensors, with NaN in every position past each row's walk; then decode
   again at the row lengths the main path's burst reaches
   (`decode_bfloat16_burst`), and (since the speculation slice) linear and
   tree verify at T=4 and T=7 slots there, bf16 and int8 pages: the shapes
   phase 10's verify passes give the kernel. The tree cases carry a row
   with history but no live node, which must output zeros. Each case
   times the whole wrapper call (the split kernel and its merge).
3b. The int8 weight product (`dynamo_tpu_torch/ops/csrc/int8_matmul.cu`)
   against its plain version evaluated in float32 on the same values, at
   every llama-8b decode shape (wq/wo, wk/wv, w_gate/w_up, w_down, lm_head
   with f32 logits) for M = 1, 8, 16, 32, 64, 128 and 256 rows (the decode
   kernel up to 8 rows, the wide entry above: decode buckets and verify
   passes), w_gate/w_up and w_down at 512 and 2048 rows (prefill chunks),
   an odd shape in bf16 and f32, wq in f32 and lm_head with a bf16 scale
   (`TOL_INT8`); every case called twice, bit-identical, its route's
   counter moved. First the wide entry's blocks per SM, as the built
   kernel's occupancy gives them, held to its split plan's table. Kernel,
   plain, library (one `torch.matmul` of the same x with a bf16 w of the
   same shape), dequantize + `torch.matmul` (the prefill route, inline) and
   bound times, and their sums over one substep's 225 products at each M.
   Since the tensor-parallel slice also one tp=2 rank's shards of those
   products (`INT8_TP_SHAPES`: wq [4096, 2048], wk/wv [4096, 512], wo
   [2048, 4096], w_gate/w_up [4096, 7168], w_down [7168, 4096], lm_head
   [4096, 64128]) at M = 8 and 32, the same checks and times, summed over
   a rank's substep; and phase 3 the attention decode case at the burst's
   lengths with a rank's 4 kv heads (`decode_bfloat16_burst_kvh4`). Then the
   kernel's tied-head entries, for llama-1b and llama-3b, whose logits use
   the int8 embedding [V, D] as emb.T (`tied_head_phase`): first the tied
   wgmma entry's blocks per SM, held to its plan's table; at llama-3b's
   head for M = 1, 8, 16, 32, 64, 128 and 256 and llama-1b's for M = 8
   (bf16 x: the tied wgmma entry), and llama-3b's at M = 8 with f32 x (the
   first tied entry), the same checks and kernel, plain, library (bf16
   `torch.matmul` on the dequantized head), dequantize + `torch.matmul`
   (the prefill route, which took bf16 heads of more than 64 rows before
   the wgmma entry) and bound times.
4. Main path at full width: `run --in batch:`'s pipeline (preprocessor →
   Backend → TorchEngine) serving 8 concurrent llama-8b completions with
   random weights made on the card, at the default pipeline depth 2 with
   every K-step window a CUDA-graph replay (the burst's window shapes are
   captured first, `LocalRunner.warm_windows`); the kernel's launch
   counter is zeroed just before the requests and read just after. Then
   the same burst again at pipeline_depth=0 (its own counts zeroed and
   read), whose 8 token and logprob streams must be identical, request 7
   once more on its cached prefix (the reference of phase 7's repeat),
   and one prompt alone again under torch.profiler. Decode ms per substep,
   tokens/s, TTFT per request, the host-blocked share, graph capture and
   pool numbers and the device-busy share are printed beside the card's
   name and power limit. Since the prefill slice every prefill dispatch
   is a graph replay too: the engine captures its prefill lattice first
   (`LocalRunner.warm_prefills`: count, capture seconds and pool bytes
   printed), the bursts run no eager prefill, each captured shape's
   replay equals eager bit for bit on two seeded waves back to back
   (`prefill_graph_checks`), chunks of 64, 512 and 2048 tokens are timed
   as graph and op by op against their bound (`prefill_timing`), and
   phase 4s's lone TTFT is taken again at pipeline depth 0
   (`lone_ttft_depth0`). 4b's runs warm their prefill lattice too; the
   int8-page run also holds every shape to eager.
4b. The main path at int8 weights (random int8 made on the card, seed 0),
   twice: bf16 KV pages and int8 KV pages. Each serves the same burst at
   depth 2 and 0 (streams identical), holds the attention launches to 32 x
   substeps and the int8 launches to the shape rule (`int8_expected`: 225
   per decode substep on the decode kernel; a prefill's layer products on
   the wide entry, its last-token head on the decode kernel), and times
   and profiles one "simple" window replay. Printed beside the bf16
   burst's numbers: tokens/s, host ms per substep, replay device ms per
   substep, TTFT, peak memory and graph-pool bytes.
4c. The wide entry on a serving path (`wide_phase`, after 4b's bf16-page
   run, on its weights' first `CUT_LAYERS` layers, which an 8-sequence
   engine of its own serves as the reference): an int8 engine of 128
   sequences (bf16 pages,
   max_model_len 2048, depth 2) serves 128 seeded completions at once
   (`wide_requests`: prompts of 64-512 byte tokens, 64 tokens each, 8 at
   temperature 0.7), so its decode runs buckets 32 and 128 (and 8 when the
   last admissions leave a window to a few rows) as it fills and drains.
   No window or step runs eagerly; the int8 launches are held to
   `int8_expected` over the engine's substeps by bucket (225 per substep
   on the bucket's route) and its prefills, the wide entry's exactly;
   every greedy stream is held against the same request served by that
   engine of 8 sequences (the decode kernel at M=8), token for token
   except where the reference's top-2 gap is under `SPEC_GAP_TOL`.
   Then a window at buckets 32 and 128 as a graph replay bit-identical to
   op by op, and at 8, 32 and 128 its replay device ms per substep, with
   one profiled replay by kernel family at 32 and 128. Tokens/s, substeps
   by bucket, host ms per substep and peak memory are printed beside the
   card's name and power limit.
4d. A full-depth tied model on a serving path (`tied_phase`, after 4b):
   llama-3b at all 28 layers, int8 weights from seed 0 quantized on the
   card, bf16 pages, block 16, max_model_len 2048, an engine of 128
   sequences at depth 2, serving 128 seeded completions at once
   (`tied_requests`: prompts of 64-256 byte tokens, 32 tokens each, 8 at
   temperature 0.7), so its decode runs buckets 8, 32 and 128. No window
   or step runs eagerly; the tied head launches exactly once per forward
   (substeps + prefills), the prefill route never, the layer products as
   `int8_expected` says by bucket. Then on a runner of its own: a
   bucket-128 window op by op, its first substep's head x through the tied
   entry within `TOL_INT8` of `int8_matmul_ref` on the card; the same
   window as a graph replay bit-identical to op by op; replay device ms
   per substep at buckets 8, 32 and 128 with one profiled replay each (the
   head's share); and bucket 128's window captured alone with the head on
   the tied entry and on the prefill route, in turns: replay ms and graph
   pool bytes. Tokens/s, substeps by bucket, peak memory and graph-pool
   bytes are printed beside the card's name and power limit.
4e. A mixture-of-experts model on the main path (`moe_phase`, after 4d):
   moe-wide at its full 12 layers (d 2048, 64 experts, top 8, expert
   width 1024, a tied 32,000-row head), bf16 weights from seed 0 made on
   the card, bf16 pages, the main path's engine (`run`'s
   `build_pipeline`: 8 sequences, depth 2, 8-step windows, every window
   shape captured first) serving the burst, then its greedy requests
   again at depth 0: the same streams. No window or step runs eagerly,
   the attention launches 12 x substeps, the int8 entries never. Then on
   a runner of its own (128 sequences): a bucket-8 window op by op, each
   layer's MoE input as it reached the FFN at its first substep recorded;
   the same window as a graph replay bit-identical to op by op; the
   port's `_moe` on the card on one layer's recorded input against a
   float64 loop over each row's chosen experts on the host: the same
   experts and outputs within `MOE_TOL` wherever the reference's k-th and
   (k+1)-th probabilities are more than `MOE_GAP` apart (the rows left out
   counted), and no copy of an expert stack in the call; replay device ms
   per substep at buckets 8, 32 and 128 with one profiled replay each;
   and the MoE alone, 12 layers as one graph, at 8, 32 and 128 rows and
   a 1,536-token prefill chunk: device ms per layer, kernels, bound and
   its share of the replay, by family (expert products, router softmax,
   sort, scatter). Printed beside the card's name and power limit:
   tokens/s, host ms per substep, prefill host seconds, peak memory,
   graph-pool bytes, and the dense and routed byte bounds per substep
   (the routed one from the experts the recorded rows chose).
4t. Tensor parallelism (`tp_phase`, after phase 10's checkpoint is
   written): the store and `python -m dynamo_tpu_torch.worker --tp 2`
   with llama-8b at full width and `CUT_LAYERS` layers from that
   checkpoint (bf16; each rank keeps its shards as it loads), block 16,
   8 sequences, max_model_len 2048. The worker is rank 0 and spawns rank
   1; the two share the one card and meet over gloo, so their windows run
   eagerly. Phase 4's burst goes through the worker's `generate` endpoint
   over the runtime: every greedy stream equals the burst in process at
   tp 1 on the same checkpoint (`burst_reference`, run while the worker
   starts) except where the two passes' chosen tokens are within
   `SPEC_GAP_TOL` nats (the rule `tree_vs_dense_gaps` applies); the
   follower's sampled-token digest equals the leader's bit for bit, the
   two made the same collectives, and each launched the attention kernel
   8 x substeps. Then the int8 leg: int8 weights and pages from the same
   checkpoint, with a 4-slot adapter bank and two adapters of ranks 8 and
   16 (`TP_ADAPTERS`; each rank holds its shard of the bank), held the
   same way against the burst in process at tp 1 on the same checkpoint
   with the same adapters: the burst as it is, then, after a cache
   clear that also sets every rank's launch counts to 0, with half its
   rows under an adapter (`TP_LORA_ROWS`), whose base rows equal the plain
   burst's token ids and logprobs bit for bit and whose adapter rows each
   differ from their plain row; every greedy stream's logprobs within
   `TP_LP_TOL` of tp 1's until it leaves it; on each rank, read on that
   rank, the attention kernel launched 8 x each burst's substeps; both
   ranks count the same LoRA-variant windows. Printed beside the card's
   name and power limit: the backend, tokens/s, host ms per substep,
   collectives and bytes per substep, host seconds in collectives, peak
   memory per rank, and the mixed burst's tokens/s and launches.
4p. The ops no engine calls (`parallel_phase`, after phase 4): two rank
   processes spawned once, sharing the card over gloo (ep 2 blocks of one
   tp rank; the ring over both), run three checks: `ring_prefill` at
   llama-8b's attention widths (T 8,192, H 32, KVH 8, hd 128, bf16, sp 2),
   causal and not, against a dense f32 attention computed in 512-row
   chunks on rank 0 (`PAR_RING_TOL`); `pipeline_apply` of 32 residual
   RMSNorm + SwiGLU layers at llama-8b's MLP widths (D 4,096, I 14,336,
   bf16, pp 2, B 16, M 4) against the sequential scan (`PAR_PIPE_TOL`);
   and four moe-wide float32 decode steps with the experts over ep 2
   against the unsharded step (`PAR_EP_TOL`), the attention kernel
   launched 12 times a step on each rank. The ring and the pipeline run
   once more over an exchange that hands each rank its own tensors back
   (`_LostExchange`), and those controls' errors must leave the bounds.
   The max errors, ms by rank,
   exchanges and bytes are printed beside the card's name and power
   limit; `--tp-nccl` runs the phase again at 2 and 4 ranks over NCCL,
   each rank on a card of its own.
4s. The SLA profile (`sweep_phase`, at the end of phase 4's bf16 run, on
   its engine: llama-8b, 32 layers, 8 sequences): `planner.profile_sweep.
   sweep` at batches 1, 2, 4, 8 (each warmed, then B concurrent greedy
   requests of a 64-token random prompt and 96 tokens: ITL = 1000·B /
   tokens/s) and prompt lengths 64-1,024 (TTFT of one request alone).
   Every sample finite and positive, tokens/s at B=8 above B=1, no window
   eager, attention launches 32 x the sweep's substeps. The npz goes to a
   temporary directory for phase 7's workers; both curves are printed
   beside the card's name and power limit.
5. Graph parity: one K=8 window at llama-8b shapes (all 32 layers, the
   engine's weights, its own small cache) as a CUDA-graph replay and op by
   op, in each sampler mode: tokens, logprobs, top-n, the written KV pages
   and the chain buffer bit-identical; two chained windows against the
   same two drained; at the burst's row lengths, each mode's replay device
   time per substep against the op-by-op window, one profiled replay by
   kernel family; and the threefry noise's device time per substep
   (batch 8, the full vocabulary).
6. A small-input reference: test-tiny in float32 through the model with
   the kernel and with the plain attention, tokens equal.
7. The distributed serving path over HTTP: the in-process engine freed,
   the port's store server, two `python -m dynamo_tpu_torch.worker`
   processes (the main path's engine arguments, seed 0, so the same
   weights) and a kv-mode `python -m dynamo_tpu_torch.frontend`. The same
   8 /v1/completions as the main path's burst (even ones as SSE streams,
   odd ones aggregated, over raw asyncio sockets), two chat completions
   (streamed and aggregated, equal), one burst prompt again, then, after
   /clear_kv_blocks, the burst once more, all 8 aggregated. Every
   response must be 200, every stream end in [DONE], every completion
   carry 64 tokens and equal the in-process burst's text for the same
   request; every aggregate response must carry the in-process burst's
   64 token texts and logprobs bit for bit, and both workers must have
   served such a response; the repeated prompt must land
   on the worker that served it first (the router's choice, read from the
   frontend's ledger and traces) and carry the token texts and logprobs
   of the in-process prefix-hit pass bit for bit; each worker's kernel
   launches (counted from after its graph warm-up, printed on its last
   line at SIGTERM) must equal 32 x its decode substeps; every process
   must exit 0 on SIGTERM. The frontend ledger's TTFT of the aggregate
   requests, each pass's tokens/s against the in-process burst, each
   worker's start-up and graph warm-up seconds and msgpack_lite's
   microseconds per frame are printed beside the card's
   name and power limit. The workers run with `--kv-directory on` and
   export their spans to the store (`DYNTPU_TRACE_EXPORT=1`).

   7b. The frontend fleet (`fleet_phase`), after phase 7's frontend has
   exited 0: `python -m dynamo_tpu_torch.frontend --fleet 2
   --global-max-inflight 16 --router-mode kv` over the same store and
   workers, with trace export. From cleared caches, through the port's
   `OpenAIClient` (one connection a request, a traceparent each): the
   burst's 8 completions aggregated, phase 7's chat streamed
   (`chat_stream`) and aggregated, and request 7 again. Both children
   must be registered on the one port and serve; every burst response's
   token texts and logprobs must equal phase 7's reference bit for bit and
   the repeat its prefix-hit reference, on the worker that served request
   7; each request's stitched trace (`/debug/fleet/traces/<id>`) must hold
   a frontend and a worker lane with engine.queue, engine.prefill
   (`prompt_tokens` the prompt's length, `cached_blocks` 0 cold and above
   0 on the repeat) and engine.decode (`tokens` 64); every aggregated
   `/debug/requests` record must carry the engine phases; each worker's
   `/metrics` must count one engine.decode span per request it served; the
   prefix directory must list each burst request's prompt blocks under the
   instance that served it; each worker's attention launches over the
   phase must equal 32 x its substeps; the supervisor must exit 0 on
   SIGTERM. The fleet's tokens/s and ledger TTFTs beside phase 7's, and
   the workers' host µs per request for recording the engine spans and for
   the exporter, are printed beside the card's name and power limit.

   7c. The control plane (`control_phase`), after 7b, over the same
   workers, which run `--autoscaler on --sla-profile` phase 4s's npz: a
   `--qos --record-dir` kv frontend adopts the profile from their model
   card (its log line) and `discover_card_profile` finds the npz's arrays;
   the router service's `route` for request 7 names the worker the
   frontend places it on with the overlap the frontend's router counts,
   its `generate` streams request 7 with the prefix-hit reference's
   logprobs bit for bit; the metrics exporter lists both workers, its
   per-worker gauges equal each worker's own load_metrics and
   fleet_workers_live counts them. Reference passes (six
   completions of 256-576 tokens, 1,000 tokens each, top-2, through the
   frontend; seven 576-token rows pinned on one worker) from empty
   caches, then `python -m dynamo_tpu_torch.planner --operate
   --profile-from-discovery --balance on --decision-log` with a TTFT SLA
   of half the smallest profile TTFT over the leg's prompt lengths
   (256-576 tokens) and an ITL SLA of 10x its ITL
   at B=8 (a fresh ControlLaw predicts the first action: a pool move
   decode → prefill). The completions run again: the planner moves one
   worker to the prefill pool (journal entry ok, pools 1/1, its metric
   counted), the moved worker's streams relocate (one ok migration each,
   no fallback) and each equals its reference up to its cutover (read
   from the frontend's recorded legs) and then by the gap rule, every
   other stream bit for bit. The worker goes back to decode (admin RPC;
   the law's cooldown holds it there), the pinned rows run again, the
   balancer's migrate_out moves one of them to the idle worker (the gap
   rule again, the rest bit for bit), the exporter shows the busy
   worker's active slots above 0, pools and journal unchanged. The
   decision log replays through a fresh ControlLaw to the same decisions
   (one action: the pool move); each worker's attention launches over 7c
   equal 32 x its substeps; every process exits 0. Decision lag, the
   move's KV MB/s (the KV the destination received over the moved
   worker's migration.out span time), client-visible stalls and
   divergences are printed
   beside the card's name and power limit.

8. A checkpoint on disk through the worker: llama-8b widths with 2 layers
   (seed 0, bf16, two safetensors shards, an index and config.json, ~3 GB)
   under build/checkpoints/, loaded in process with `load_model(quant=
   "int8")` (every leaf equal to `quantize_params_np` of the written
   arrays), then served by `python -m dynamo_tpu_torch.worker --model-path
   <dir> --quant int8 --kv-quant int8 --tokenizer byte` behind the store and
   a kv-mode frontend: the burst's first 4 requests as aggregate
   completions, each bit-equal (token texts and logprobs) to an in-process
   engine on the loaded weights with the same engine arguments; launches
   held as in 4b; load and launch-to-registration seconds printed.
9. The checkpoint's own tokenizer at full width: a Llama-3.1-shaped
   tokenizer.json (128,256 ids: 128,000 BPE tokens, the first merges
   learned from README.md and SURVEY.md, the rest filled from a seeded RNG,
   and the 256 specials; Split + ByteLevel, ignore_merges, a BOS template)
   and a generation_config.json (EOS 128001, 128008, 128009) written into
   phase 8's checkpoint, which `python -m dynamo_tpu_torch.worker
   --model-path <dir> --quant int8 --kv-quant int8` then serves with no
   --tokenizer behind the store and a kv-mode frontend: 4 chat and 4
   completion requests cut from README.md at the burst's lengths, 64
   tokens each, each bit-equal (token texts and logprobs) to an in-process
   engine on the loaded weights fed the port tokenizer's ids, with
   usage.prompt_tokens as the port's preprocessor counts them; the worker's
   launches for them (read on SIGUSR1) held as in phase 8. Then one
   mixed-priority check on the same worker (its KV pool sized so that two
   batch requests outgrow it): engine_preemptions_total{class="batch"}
   rises and the interactive response equals its solo run. The
   tokenizer's load seconds (frontend, in process), encode microseconds
   per token and characters per token over the 8 prompts, DecodeStream
   microseconds per token over the 512 generated tokens and the worker's
   launch-to-registration seconds are printed as host numbers beside the
   card's name and power limit.

Phases 10-14 run llama-8b's widths at CUT_LAYERS (8) layers, so that the
script ends within its time: phases 10 and 12a make that model in process
from seed 0 (`cut_config`), and the workers of phases 11, 12b, 13, 14 and
15b load the same weights from a checkpoint of it written once here with
phase 8's writer (`write_checkpoint`, bf16; `--quant int8` quantizes it as
it loads). Every check of those phases holds at that depth: launch counts
are layers x substeps, and every reference is an in-process engine on the
same weights.

10. Speculative decoding at the cut depth, twice: bf16, and int8 weights
   with int8 pages. `run`'s pipeline with `--spec-tokens 3` (spec_gate 0)
   serves the burst's 8 requests (top-2 logprobs each) in turn dense
   (spec_tokens 0: the reference), linear fused (twice: the repeat must
   give the same streams), linear stepwise and tree (width 2, depth 3,
   1-gram drafts), every verify shape captured ahead of its burst
   (`runner.warm_spec`). Stepwise greedy streams must equal the dense ones
   bit for bit; a fused or tree greedy stream may leave the dense one only
   where the dense top-2 gap is under `SPEC_GAP_TOL` (the count is
   printed); the tree burst must dispatch branched passes. Every burst
   holds attention launches to 32 × (dense substeps + verify forwards: 1
   per fused pass, S1 per stepwise pass), int8 calls to 225 per forward
   (a fused or tree pass's B x S1 rows on the wide entry, a stepwise
   pass's 8 on the decode kernel, none on the prefill route), and no
   eager window or verify pass. Then verify passes at the burst's row lengths on a
   runner of their own: graph replay bit-identical to the op-by-op pass
   (linear, stepwise, tree; S1 = 4 and 7) and its device time against one
   dense substep. Tokens/s, tokens per weight pass, accept rates, launches
   per pass and the verify graphs' count and pool bytes are printed beside
   the card's name and power limit. Since the prefill slice the bf16 run
   also serves the dense burst with `prefill_batch_max` 4 and the tail
   split off (`packed_prefill_pass`): two packed dispatches of two rows,
   greedy streams held to the singles pass's under the gap rule.

11. Disaggregated prefill/decode at the cut depth (the checkpoint), twice:
   bf16, and int8 weights with int8 pages. The store, one `python -m
   dynamo_tpu_torch.worker --is-prefill-worker --component prefill` and
   one default worker (`--disagg auto`, `--max-local-prefill-length 512`),
   both with the main path's engine arguments (seed 0: the same weights),
   and a kv-mode frontend; the burst as 8 aggregate /v1/completions. The
   prompts of 768, 1024, 1280 and 1536 tokens (`REMOTE`) must prefill
   remotely (queue dispatch), each moving (prompt - 1) // 16 full blocks
   over the streaming data plane into the decode worker's cache, and the
   other four locally: disagg_remote_prefill_total 4 and no fallback, on
   the decode worker's /metrics and counters line. Every remote response
   must equal the in-process engine's pass of the same request on its
   cached prefix (`checkpoint_reference` on the same checkpoint, made as
   main_path makes its `reference["repeats"]`: an injected prompt is
   admitted as the same prefix hit), every local one the cold burst:
   token texts and logprobs bit for bit. The decode worker's launches
   (SIGUSR1) are held to layers x its substeps and, with int8 weights, to the
   shape rule over its prefills (the local prompts, and each remote
   prompt's 16-token suffix); the prefill worker decodes nothing. Request 7
   is then sent alone from an empty cache (one transfer with nothing else
   running, held to the same reference). Then, in the bf16 pass (one
   chaos cell, as in phase 14), the prefill worker is replaced by one
   started with
   `DYNTPU_CHAOS_ENABLED=1 DYNTPU_CHAOS_TRANSFER_CUT_P=1`, the decode
   worker's cache cleared, and request 7 sent again: its transfer is cut,
   the decode worker falls back to a local prefill
   (disagg_fallback_total{reason="transfer"} 1) and returns the cold
   burst's stream. Every process must exit 0 on SIGTERM. Each remote
   request's bytes, chunks, overlap_frac, dispatch-to-last-chunk seconds
   and MB/s, every request's TTFT (frontend ledger) beside phase 7's (bf16)
   or the in-process burst's (int8), the decode worker's drain_sync share
   and inject seconds, and the host cost of one 47-block chunk on the wire
   (`kv_wire_timing`) are printed beside the card's name and power limit.

12. Structured output and embeddings at the cut depth. 12a, twice (bf16;
   int8 weights with int8 pages): `run`'s pipeline with `--spec-tokens 3
   --spec-ngram 1 --spec-tree-width 2` (spec_gate 0, unpipelined) serves
   the burst's 8 prompts as chat completions with a bounded json_schema
   (`GRAMMAR_RF`: enum, const, boolean, integer, a string of at most 8
   characters; max_tokens 128, top-8 logprobs, seeds 1000-1007, rows 3
   and 6 at temperature 0.7), dense, tree, dense again, each burst's
   masked single-step and masked tree verify graphs captured ahead. Every
   response finishes stop and validates, every token is legal under the
   FSM, the repeat equals the first dense burst bit for bit, a tree
   greedy stream leaves the dense one only where the two legal tokens'
   logprobs are within `SPEC_GAP_TOL` of each other, either way round;
   attention launches are 32 ×
   (single steps + verify forwards), int8 calls 225 per forward (prefill
   by `int8_expected`), every verify pass a tree pass, nothing eager on
   the card. Then on a runner of its own the masked single step and the
   masked tree pass (S1 4, 7) as graph replays bit-identical to op by op,
   and their device times against their unmasked twins and a dense
   substep. The bf16 run embeds four cuts of the burst's prompts in
   process and holds each vector to a plain float32 forward of the same
   weights (`embed_f32_reference`: no padding, an explicit causal mask, a
   plain mean) within `EMBED_REL_TOL` relative L2. 12b: the store, one `python -m dynamo_tpu_torch.worker` (the
   main path's engine arguments) and a kv frontend: two schema chats (SSE
   and aggregate) equal to 12a's dense responses, token texts and
   logprobs bit for bit; a json_object chat; an unsupported schema's
   typed 400; /v1/responses with text.format; /v1/embeddings with the
   four cuts (one of 1,536 tokens) bit-equal to 12a's in-process vectors,
   twice with the same bytes; the worker's launches (SIGUSR1) 32 × its
   single steps; every process exits 0 on SIGTERM. 12c, host only: the
   grammar compiler over a 128,256-id Llama-3.1-shaped tokenizer.json
   and the schema's first 16 states lifted, each a walk of the
   vocabulary. Compile seconds, mask seconds, constrained tokens/s dense
   and tree, replay device times, mask bytes per upload, graph counts
   and pool bytes, embedding ms and tokens/s, compiler build and lift
   seconds are printed beside the card's name and power limit.

13. KV tiers and peer prefix fetch at the cut depth (the checkpoint), twice (bf16; int8
   weights with int8 pages). 13a, in process (`tiers_phase`): one engine
   with a 512-block G2 and a G3 directory serves the burst (64 tokens,
   logprobs) with its tiers off (a disabled stack), cold with them on, on
   its G1 hit (the reference of every onboarded stream), with them off
   again, and, after clear_kv_blocks, onboarded from G2; engines on the
   same weights with a 32-block G2 then serve it onboarded from G3, and
   from G3 after a restart (a fresh engine on the directory). Every
   onboarded pass must onboard every full prompt block (346), as many as
   the tiers held before it (peek_run_len), prefill only the suffixes, and
   give the G1-hit pass's 8 streams bit for bit (tokens and logprobs); the
   onboarded pages read back bit-equal to the stored ones; no G2 page keeps
   a view of a staging buffer; launches held per pass; no eager window.
   13b (`tiers_worker_phase`): the store and two workers (`--disagg off`,
   one shared `--fleet-kv-dir`; A `--host-kv-blocks 512`, B 32) over a
   DIRECT router: A serves the burst cold and on its G1 hit; B serves it
   one request at a time with `peer_prefix` hints naming A (8 peer
   fetches, every block injected, the suffixes prefilled); A serves 8
   other prompts (its G2 spills into the fleet directory); B, its cache
   cleared, serves the burst from G2 + G4 (`tier_g4_hits_total` > 0, its
   dedup counter counting its identical writes). Every stream equals 13a's
   G1-hit pass bit for bit; every process exits 0 on SIGTERM. Offloaded
   bytes, device→host MB/s, host ms per flush, tokens/s of the cold burst
   with the tiers on and off, TTFT cold / G1 hit / G2 / G3 / restart /
   after a peer fetch, G3 read and peer fetch MB/s, G2 host bytes, G3 and
   G4 file bytes and peak device memory are printed beside the card's name
   and power limit.

14. Live migration and the worker role manager at the cut depth (the
   checkpoint), twice
   (bf16; int8 weights with int8 pages; `migration_phase`). The store and
   three `python -m dynamo_tpu_torch.worker --autoscaler on --disagg off`
   workers (the main path's engine arguments, seed 0), C with the chaos
   plan `cutover:dest` (the int8 pass runs A and B only: one chaos cell); 8 requests (`migration_requests`: prompts of
   256-1,024 byte tokens, 1,000 tokens each, top-2 logprobs, six greedy and
   two at temperature 0.7) through this process's Migration operator over
   a KvPushRouter, the migrations through each worker's workerctl/admin
   endpoint. The reference pass on A; the chaos cell on C (384 tokens a
   stream), whose offer of a sampled row to A falls back at the cutover
   with the typed reason while every stream stays bit-equal to the
   reference's first 384 tokens, then C retires (B
   meanwhile serves one top-2 request, capturing the window graph its
   later streams use); the clean pass on A (its cache cleared): at 64
   tokens four greedy rows migrate to B, two at a time, all ok with no
   fallback and 4 markers consumed; B takes two new requests, then
   `set_role prefill` relocates B's running streams to A and `set_role
   decode` brings it back; every stream completes with 1,000 tokens
   (`MIG_TOKENS`: ~10 s a row, so that no row ends while six relocations
   run in turn), unmoved rows bit-equal to the reference and relocated
   ones equal up to their first cutover and then token for token but
   where the reference's top-2 gap is under `SPEC_GAP_TOL`
   (`relocated_divergence`); a prefill-only export of each migrated row's
   streamed tokens from A and from B, its last streamed block left out,
   gives the same page bytes (the pages B injected are the pages A held);
   B retires and only A's `autoscaler/<ns>/workers/` key remains; every
   worker's attention launches are 32 x its substeps, no window eager,
   every process exits 0, and no fallback fires outside the chaos cell.
   Per migration its KV bytes, blocks, seconds, MB/s and cutover gap, the
   client-visible stall of each relocated stream, host ms per
   `_pump_migration`, tokens/s of A's unmoved rows against the reference
   pass, the pool move's and the retirement's seconds and each worker's
   peak device memory are printed beside the card's name and power limit.

15. Multi-LoRA at llama-8b's widths and CUT_LAYERS layers (the depth of
   phases 10-14, so that the script ends within its time), twice (bf16;
   int8 weights with int8 pages; `lora_phase`): a bank of 4 slots at rank
   16, six adapters of ranks 16 and 8 (`LORA_ADAPTERS`) registered through
   a 1,024-block G2, the burst with six rows under adapters and two base
   rows sent at once (admissions wait for a slot, adapters page in from
   G2): at depth 2 and 0 (identical streams), base-only (base rows
   bit-identical), with tree speculation (verify passes carrying adapter
   rows; the gap rule against the dense pass) and one adapter chat under
   `GRAMMAR_RF`; launch counts exact in every pass, nothing eager; adapter
   rows teacher-forced against merged q/k/v/o weights
   (`lora_reference`); the LoRA window's replay against the pre-LoRA one.
   15b (`lora_worker_phase`): a `--lora` worker on the cut checkpoint
   behind a kv frontend, /v1/models listing the adapters, an adapter and a
   base request aggregate and SSE equal to an in-process engine. Tokens/s
   mixed against base-only, replay ms and kernels per substep with and
   without the LoRA variant, graphs, capture seconds and pool bytes with
   and without it, the bank's bytes, page-ins and their ms, the slot waits
   and peak memory are printed beside the card's name and power limit.

Each phase's seconds and the running total are logged as it ends.

`python3 chip_smoke.py --tp-nccl`, on a host of two or more cards, runs
only phase 4t's bf16 leg with the int8 leg's adapters, each rank on a
card of its own (NCCL, windows captured with their collectives inside):
at tp 2, and at tp 4 when four cards are visible; then phase 4p at 2 and
4 NCCL ranks (`tp_nccl_main`).

The last lines are the kernels JSON line (the attention kernel's decode
entry, the int8 product, its wide entry, its tied-head entries with phase
4d's launches, and the attention kernel's
linear and tree verify modes; the first two also carry phase 11's decode
worker's launches, the decode, tree and int8 entries phase 12's, the
first two phases 13's and 14's, and all of them phase 15's; the decode
entry's `launches_fleet` counts phase 7b's, `launches_sweep` phase 4s's and
`launches_planner` phase 7c's; `launches_tp_ranks` on the decode, int8 and
wide entries phase 4t's plain bursts, rank by rank; on the decode entry
`launches_tp_ranks_int8_adapter_rows` 4t's mixed burst, each rank's count
set to 0 before it, and `launches_ep_ranks` phase 4p's ep ranks),
nvidia-smi's name/power line, and {"ok": true, "device": {...}}. Without
CUDA, or without the rest of the repository beside this file, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import asyncio
import json
import os
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS = {"bfloat16": 989e12,    # dense tensor-core bf16
            "float32": 67e12}      # f32 outside the tensor cores
TIMED_RUNS = 30
WARMUP_RUNS = 3
SPIN_CYCLES = 400_000  # ~0.2 ms of GPU spin ahead of each timed call
KERNEL_SOURCE = "dynamo_tpu_torch/ops/csrc/paged_attention.cu"
KERNEL_REPLACES = "dynamo_tpu/ops/paged_attention.py:210"
KERNEL_VERSION = 3
# Row lengths the main path's decode sees: the burst's prompts (64-1536
# byte-tokens) at mid-generation.
BURST_HIST = [96, 192, 352, 544, 800, 1056, 1312, 1568]
# The main path's burst: 8 prompts of these byte lengths, these
# temperatures, seeds 1000-1007, 64 tokens each.
BURST_LENS = [64, 160, 320, 512, 768, 1024, 1280, 1536]
BURST_TEMPS = [0.0, 0.0, 0.0, 0.7, 0.0, 0.0, 0.7, 0.0]
BURST_TOKENS = 64
# The decode worker's threshold: prompts with more uncached tokens than this
# prefill remotely in phase 11 (the worker's default).
MAX_LOCAL_PREFILL = 512
# The burst's requests that go remote: 768, 1024, 1280 and 1536 tokens (the
# byte tokenizer adds no BOS, so a prompt's tokens are its characters).
REMOTE = [i for i, n in enumerate(BURST_LENS) if n > MAX_LOCAL_PREFILL]
# The request rerun against a prefill worker that cuts every transfer.
CHAOS_REQUEST = REMOTE[-1]
# Engine arguments of the main path, shared by its in-process pipeline and
# the HTTP phase's workers.
ENGINE_ARGV = ["--block-size", "16", "--num-kv-blocks", "2048", "--max-num-seqs", "8",
               "--max-model-len", "2048", "--decode-steps", "8", "--seed", "0"]
HERE = os.path.dirname(os.path.abspath(__file__))
# Depth of the llama-8b-width model that phases 10-15 serve (every width as
# llama-8b's; the full 32 layers run in phases 3-9): the in-process engines
# of phases 10, 12a and 15a make it from seed 0 (`cut_config`), and phases
# 11, 12b, 13, 14 and 15b's workers load the same weights from a checkpoint
# of it (`write_checkpoint`), so the script ends within its time.
CUT_LAYERS = 8

# The kernel is held against its plain PyTorch version evaluated in float32
# on the same values (bf16 → f32 is exact; int8 pages are first dequantized
# and rounded to q's dtype, the kernel's own rounding point), as
# |kernel - plain| <= atol + rtol * |plain|. float32 q: only the summation
# order differs. bfloat16 q: the kernel also rounds its f32 result to
# bfloat16 once, at most half a bfloat16 step (2^-8 of the value).
TOL = {"float32": (2e-5, 1e-5), "bfloat16": (1e-4, 2.0 ** -8 + 1e-3)}


def log(msg: str) -> None:
    print(msg, flush=True)


def reference_entry(gen, ttft_s: float) -> dict:
    """One in-process request as the HTTP phase's reference: its text, and
    its per-token logprobs and token texts as an aggregate completion
    carries them."""
    choice = gen.final_response()["choices"][0]
    return {"text": choice["text"], "logprobs": list(gen.lp_values),
            "lp_tokens": choice["logprobs"]["tokens"], "ids": list(gen.lp_tokens),
            "ttft_s": ttft_s}


def burst_prompts() -> list[str]:
    import numpy as np

    rng = np.random.default_rng(2024)
    return ["".join(chr(c) for c in rng.integers(32, 127, n)) for n in BURST_LENS]


# Tree topologies of the kernel cases, by slot count: parents of nodes 1..
# (T=4 and T=7 are the verify shapes of phase 10's tree run, width 2 and
# depth 3 at spec_tokens 3: S+1 and 2S+1 slots).
TREE_PARENTS = {4: [0, 0, 1], 5: [0, 0, 1, 1], 7: [0, 0, 1, 1, 3, 2]}


def _tree_anc(parents, T):
    import numpy as np

    anc = np.zeros((T, T), np.int8)
    anc[0, 0] = 1
    for j, p in enumerate(parents, start=1):
        anc[j] = anc[p]
        anc[j, j] = 1
    return anc


def make_case(mode, qdt_name, quant, seed, device, hist, T=5, KVH=8, G=4, hd=128, bs=16,
              L=2, layer=1, width=None, no_live=()):
    """Inputs for one kernel case → dict with the wrapper's ``args`` (CUDA
    tensors on ``device``) and host metadata. ``hist`` are per-row history
    lengths (0 = dead row); mode decode|linear|tree. Rows own disjoint
    pages; every position past a row's walk and every page no row owns
    holds NaN (NaN scales for int8 pages). ``width`` widens the block table
    to that many pages (the extra entries name unowned, NaN pages). Tree
    rows in ``no_live`` keep their history length but no ``anc`` bit: the
    contract is that they attend nothing and output zeros."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    B = len(hist)
    hist = np.asarray(hist, np.int64)
    live = hist > 0
    anc = None
    if mode == "decode":
        T = 1
        lengths = hist[:, None].copy()
        walk = hist.copy()
    elif mode == "linear":
        lengths = np.where(live[:, None], hist[:, None] + np.arange(1, T + 1)[None, :], 0)
        walk = lengths.max(axis=1)
    else:
        lengths = np.where(live[:, None], hist[:, None], 0).repeat(T, axis=1)
        anc = np.where(live[:, None, None], _tree_anc(TREE_PARENTS[T], T)[None], 0).astype(np.int8)
        anc[list(no_live)] = 0
        live = live & anc.any(axis=(1, 2))
        walk = np.where(live, hist + T, 0)
    pages = -(-walk // bs)
    W = max(int(pages.max()), width or 0)
    N = int(pages.sum()) + 16
    perm = rng.permutation(np.arange(1, N))
    tables = rng.integers(1, N, size=(B, W)).astype(np.int32)
    owned = np.zeros(N, bool)
    i = 0
    for b in range(B):
        tables[b, : pages[b]] = perm[i : i + pages[b]]
        owned[perm[i : i + pages[b]]] = True
        i += pages[b]
    D = KVH * hd
    qdt = getattr(torch, qdt_name)
    q = torch.from_numpy(rng.standard_normal((B, T, KVH, G, hd)).astype(np.float32)).to(device, qdt)
    if quant:
        kc = rng.integers(-127, 128, (L, N, bs, D)).astype(np.int8)
        vc = rng.integers(-127, 128, (L, N, bs, D)).astype(np.int8)
        ks = (np.abs(rng.standard_normal((L, N, bs, KVH))) * 0.02 + 1e-3).astype(np.float32)
        vs = (np.abs(rng.standard_normal((L, N, bs, KVH))) * 0.02 + 1e-3).astype(np.float32)
        poison = (ks, vs)
    else:
        kc = rng.standard_normal((L, N, bs, D)).astype(np.float32)
        vc = rng.standard_normal((L, N, bs, D)).astype(np.float32)
        ks = vs = None
        poison = (kc, vc)
    for arr in poison:
        arr[:, ~owned] = np.nan
        for b in range(B):
            for j in range(pages[b]):
                lo = walk[b] - j * bs
                if lo < bs:
                    arr[:, tables[b, j], max(lo, 0):] = np.nan
    pdt = torch.int8 if quant else qdt
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    # Attended (query, position) pairs: the work the data needs.
    pos = np.arange(W * bs)
    att = pos[None, None, :] < lengths[:, :, None]
    if anc is not None:
        slot = pos[None, None, :] - lengths[:, :, None]
        ok = (slot >= 0) & (slot < T)
        att |= ok & np.take_along_axis(anc != 0, np.clip(slot, 0, T - 1), axis=2)
        att &= live[:, None, None]
    return {
        "args": (q, t(kc).to(pdt), t(vc).to(pdt), layer, t(tables), t(lengths.astype(np.int32)),
                 t(ks) if quant else None, t(vs) if quant else None,
                 t(anc) if anc is not None else None),
        "walk": walk, "pages": pages, "att": att, "live": live, "B": B, "T": T, "KVH": KVH, "G": G,
        "hd": hd, "bs": bs, "W": W, "q_bytes": 2 if qdt_name == "bfloat16" else 4,
        "page_bytes": 1 if quant else (2 if qdt_name == "bfloat16" else 4),
    }


def plain_f32(args):
    """The plain version evaluated in float32 on the kernel's input values."""
    from dynamo_tpu_torch.ops import paged_attention as pa

    q, kc, vc, layer, tables, lengths, ks, vs, anc = args
    if ks is not None:
        kc, vc = dequant_cache(kc, ks, q.dtype), dequant_cache(vc, vs, q.dtype)
    return pa.paged_spec_attention_ref(q.float(), kc.float(), vc.float(), layer, tables,
                                       lengths, anc=anc)


def dequant_cache(c, s, dtype):
    """int8 pages [L, N, bs, KVH*hd] × scales [L, N, bs, KVH] → dtype pages
    (widen to f32, scale, round once: gather_dequant_pages's rounding)."""
    L, N, bs, D = c.shape
    KVH = s.shape[-1]
    return (c.view(L, N, bs, KVH, D // KVH).float() * s[..., None]).to(dtype).reshape(L, N, bs, D)


def bound(case, qdt_name, quant):
    """Least time (ms) the card could take for one call: each needed input
    byte read once and each output byte written once over HBM bandwidth,
    against the operations the data needs over the peak rate."""
    B, T, KVH, G, hd = case["B"], case["T"], case["KVH"], case["G"], case["hd"]
    rows = int(case["walk"].sum())
    nbytes = rows * KVH * hd * 2 * case["page_bytes"]
    if quant:
        nbytes += rows * KVH * 4 * 2
    nbytes += 2 * B * T * KVH * G * hd * case["q_bytes"]      # q in, out
    nbytes += int(case["pages"].sum()) * 4 + B * T * 4          # table entries, lengths
    if case["args"][8] is not None:
        nbytes += B * T * T
    ops = 4.0 * int(case["att"].sum()) * KVH * G * hd            # QK^T and PV, 2 ops per MAC
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[qdt_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, flush) -> float:
    """Median of TIMED_RUNS CUDA-event timings after WARMUP_RUNS. Before
    each run the L2 cache is flushed (the decode loop's other layers evict
    a layer's pages before it is read again) and the GPU spins briefly, so
    the host's enqueue of a single-launch call hides behind the spin; a
    call made of many small launches still shows its launch gaps."""
    import torch

    for _ in range(WARMUP_RUNS):
        fn()
    times = []
    for _ in range(TIMED_RUNS):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def library_call(case):
    """One PyTorch call computing the same function over K/V pre-gathered
    to dense (scaled_dot_product_attention with GQA): a yardstick only."""
    import torch
    import torch.nn.functional as F

    from dynamo_tpu_torch.ops.paged_attention import gather_dequant_pages

    q, kc, vc, layer, tables, lengths, ks, vs, _anc = case["args"]
    B, T, KVH, G, hd = q.shape
    k = gather_dequant_pages(kc[layer], None if ks is None else ks[layer], tables, KVH, hd, q.dtype)
    v = gather_dequant_pages(vc[layer], None if vs is None else vs[layer], tables, KVH, hd, q.dtype)
    seen = torch.from_numpy(case["att"].any(axis=1)).to(q.device)[:, :, None, None]
    k = torch.where(seen, k, torch.zeros((), dtype=k.dtype, device=k.device)).permute(0, 2, 1, 3).contiguous()
    v = torch.where(seen, v, torch.zeros((), dtype=v.dtype, device=v.device)).permute(0, 2, 1, 3).contiguous()
    qd = q.permute(0, 2, 3, 1, 4).reshape(B, KVH * G, T, hd).contiguous()
    mask = torch.from_numpy(case["att"]).to(q.device)[:, None]       # [B, 1, T, C]
    return lambda: F.scaled_dot_product_attention(qd, k, v, attn_mask=mask, enable_gqa=True)


def kernel_phase(device):
    import torch

    from dynamo_tpu_torch.ops import paged_attention as pa

    hist = [0, 1, 15, 16, 17, 300, 1024, 2047]
    # The tree cases add a ninth row of history 700 with no live node: it
    # must output zeros (the Pallas kernel's empty rows, the plain version's
    # contract).
    tree_hist = hist + [700]
    cases = [
        ("decode", "bfloat16", False, hist, 5), ("decode", "float32", False, hist, 5),
        ("decode", "bfloat16", True, hist, 5), ("linear", "bfloat16", False, hist, 5),
        ("tree", "bfloat16", False, tree_hist, 5), ("tree", "bfloat16", True, tree_hist, 5),
        ("decode", "bfloat16", False, BURST_HIST, 5),
    ]
    # The verify shapes of phase 10 (spec_tokens 3: S+1 = 4 and 2S+1 = 7
    # slots) at the burst's row lengths, bf16 and int8 pages.
    cases += [(mode, "bfloat16", quant, BURST_HIST, T) for mode in ("linear", "tree")
              for T in (4, 7) for quant in (False, True)]
    # A tp=2 rank of llama-8b (phase 4t): 4 of the 8 kv heads, G = 4 each.
    cases += [("decode", "bfloat16", False, BURST_HIST, 5, TP_KV_HEADS)]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    results = []
    for i, (mode, qdt_name, quant, rows, T, *kvh) in enumerate(cases):
        KVH = kvh[0] if kvh else 8
        name = (f"{mode}{'' if T == 5 or mode == 'decode' else f'_T{T}'}_"
                f"{'int8' if quant else qdt_name}" + ("_burst" if rows is BURST_HIST else "")
                + (f"_kvh{KVH}" if kvh else ""))
        no_live = (len(rows) - 1,) if rows is tree_hist else ()
        case = make_case(mode, qdt_name, quant, 100 + i, device, rows, T=T, no_live=no_live,
                         KVH=KVH)
        args = case["args"]
        out = pa.paged_spec_attention(*args)
        ref = plain_f32(args)
        torch.cuda.synchronize()
        if not (torch.isfinite(out).all() and torch.isfinite(ref).all()):
            raise RuntimeError(f"{name}: non-finite output (kernel or plain)")
        if rows[0] == 0 and float(out[0].abs().max()) != 0.0:
            raise RuntimeError(f"{name}: the length-0 row must output zeros")
        for r in no_live:
            if float(out[r].abs().max()) != 0.0 or float(ref[r].abs().max()) != 0.0:
                raise RuntimeError(f"{name}: tree row {r} (history {rows[r]}, no live node) "
                                   "must output zeros in the kernel and the plain version")
        diff = (out.float() - ref).abs()
        err = float(diff.max())
        atol, rtol = TOL[qdt_name]
        excess = float((diff - rtol * ref.abs()).max())
        ok = excess <= atol
        ms = time_ms(lambda: pa.paged_spec_attention(*args), flush)
        plain_ms = time_ms(lambda: pa.paged_spec_attention_ref(*args), flush)
        lib_ms = time_ms(library_call(case), flush)
        b_ms, b_by = bound(case, qdt_name, quant)
        splits = pa.split_plan(case["B"], case["KVH"], case["T"] * case["G"], case["hd"],
                               case["W"], case["bs"]).splits
        r = {"case": name, "max_abs_err": err, "atol": atol, "rtol": rtol, "ok": ok,
             "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
             "bound_ms": b_ms, "bound_by": b_by, "T": case["T"], "splits": splits}
        log(f"kernel {name}: max_abs_err={err:.3e} (tol {atol:g} + {rtol:g}*|plain|, "
            f"{'ok' if ok else 'FAIL'}) kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) splits={splits}")
        if not ok:
            raise RuntimeError(f"{name}: kernel disagrees with its plain version "
                               f"(max |err| - rtol*|plain| = {excess:.3e} > {atol})")
        results.append(r)
    return results


# -- the int8 weight product ----------------------------------------------------

INT8_SOURCE = "dynamo_tpu_torch/ops/csrc/int8_matmul.cu"
INT8_REPLACES = "dynamo_tpu/engine/model.py:156"
INT8_DECODE_VERSION = 2  # the decode entry (M <= 8); 1 was the split-K kernel and its merge
# llama-8b's decode products (K, N): wq/wo, wk/wv, w_gate/w_up, w_down, and
# lm_head; calls per substep beside each (32 layers).
INT8_SHAPES = {"wq_wo": (4096, 4096, 64), "wk_wv": (4096, 1024, 64),
               "w_gate_up": (4096, 14336, 64), "w_down": (14336, 4096, 32),
               "lm_head": (4096, 128256, 1)}
# One rank's shards of those products at tp=2 (phase 4t): columns of wq,
# wk/wv, w_gate/w_up and the vocabulary, rows of wo and w_down.
INT8_TP_SHAPES = {"tp2_wq": (4096, 2048, 32), "tp2_wk_wv": (4096, 512, 64),
                  "tp2_wo": (2048, 4096, 32), "tp2_w_gate_up": (4096, 7168, 64),
                  "tp2_w_down": (7168, 4096, 32), "tp2_lm_head": (4096, 64128, 1)}
INT8_TP_M = (1, 8, 32)
TP_KV_HEADS = 4  # llama-8b's 8 kv heads over tp_kv = 2
INT8_ODD = ("odd", 1000, 200)  # breaks every tile and 16-byte alignment
# The tied heads (K, N) = (D, V) of llama-1b and llama-3b: the int8 embedding
# [V, D] used as emb.T, read as stored by the kernel's tied-head entry.
TIED_HEADS = {"llama-1b": (2048, 32000), "llama-3b": (3072, 128256)}
TIED_REPLACES = "dynamo_tpu/engine/model.py:283"
# The kernel is held against its plain version evaluated in float32 on the
# same values (int8_matmul_ref on f32 x and scale), as |kernel - plain| <=
# rtol * |plain| + c * (|x| @ |w|) * |scale|. The c term is the summation
# order (the kernel's split-K and warp order against cuBLAS's, each within
# a few units of f32 rounding of the sum of |x w| over K; the tensor
# cores' f32 accumulation is looser than IEEE). The rtol term is the plain
# version's rounding points the f32 evaluation skips: for bf16 x, x @ w,
# the scale and their product each rounded to bf16, half a step (2^-8 of
# the value) each.
TOL_INT8 = {"float32": (1e-6, 2.0 ** -16), "bfloat16": (3 * 2.0 ** -8, 2.0 ** -14)}


def int8_case(M, K, N, xdt_name, seed, device, scale_dt="float32"):
    """x [M, K] unit normals in ``xdt_name``, w [K, N] uniform int8 in
    [-127, 127], per-column scales in ``scale_dt``, from a generator on the
    card seeded with ``seed``."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((M, K), generator=g, device=device).to(getattr(torch, xdt_name))
    w = torch.randint(-127, 128, (K, N), generator=g, device=device, dtype=torch.int8)
    s = (torch.rand((N,), generator=g, device=device) * 0.02 + 1e-3).to(getattr(torch, scale_dt))
    return x, w, s


def int8_tied_case(M, K, N, xdt_name, seed, device, scale_dt="float32"):
    """``int8_case`` with the weight as a tied head: an [N, K] int8
    embedding, returned as its transpose (a view, as ``_logits`` passes it)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((M, K), generator=g, device=device).to(getattr(torch, xdt_name))
    emb = torch.randint(-127, 128, (N, K), generator=g, device=device, dtype=torch.int8)
    s = (torch.rand((N,), generator=g, device=device) * 0.02 + 1e-3).to(getattr(torch, scale_dt))
    return x, emb.T, s


def int8_check(x, w, s, out_f32, label):
    """Kernel vs plain (f32 on the same values): → max |err|, or raise."""
    import torch

    from dynamo_tpu_torch.ops import int8_matmul as im

    out = im.int8_matmul(x, w, s, out_f32=out_f32)
    again = im.int8_matmul(x, w, s, out_f32=out_f32)
    ref = im.int8_matmul_ref(x.float(), w, s.float(), out_f32=True)
    absref = (x.float().abs() @ w.float().abs()) * s.float().abs()
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise RuntimeError(f"int8 {label}: two calls on the same inputs differ")
    want_dt = torch.float32 if out_f32 else x.dtype
    if out.dtype != want_dt or out.shape != ref.shape or not torch.isfinite(out).all():
        raise RuntimeError(f"int8 {label}: output {out.dtype} {tuple(out.shape)} not finite "
                           f"{want_dt} {tuple(ref.shape)}")
    rtol, c = TOL_INT8[str(x.dtype).removeprefix("torch.")]
    diff = (out.float() - ref).abs()
    excess = float((diff - rtol * ref.abs() - c * absref).max())
    if excess > 0:
        raise RuntimeError(f"int8 {label}: kernel disagrees with its plain version by "
                           f"{excess:.3e} beyond the tolerance")
    return float(diff.max())


def int8_bound(M, K, N, x_bytes, out_bytes, scale_bytes, qdt_name):
    """Least time (ms): each weight, x, scale and output byte moved once over
    HBM bandwidth, against 2*M*K*N operations over the peak rate."""
    nbytes = K * N + M * K * x_bytes + N * scale_bytes + M * N * out_bytes
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2.0 * M * K * N / PEAK_OPS[qdt_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# The products that share x, as ``_qkv`` and ``_mlp`` group them: one
# launch of the decode entry each at 1-8 rows, at full width and at a tp=2
# rank's shards.
INT8_GROUPS = {
    "qkv": ("wq_wo", "wk_wv", "wk_wv"), "gate_up": ("w_gate_up", "w_gate_up"),
    "tp2_qkv": ("tp2_wq", "tp2_wk_wv", "tp2_wk_wv"),
    "tp2_gate_up": ("tp2_w_gate_up", "tp2_w_gate_up"),
}
INT8_GROUP_M = (1, 8)


def int8_group_case(M, names, seed, device):
    """x [M, K] bf16 unit normals and, for each shape in ``names``
    (INT8_SHAPES or INT8_TP_SHAPES), w [K, N] uniform int8 and f32 scales,
    from a generator on the card seeded with ``seed``."""
    import torch

    shapes = {**INT8_SHAPES, **INT8_TP_SHAPES}
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((M, shapes[names[0]][0]), generator=g, device=device).to(torch.bfloat16)
    ws = []
    for name in names:
        K, N, _ = shapes[name]
        ws.append((torch.randint(-127, 128, (K, N), generator=g, device=device, dtype=torch.int8),
                   torch.rand((N,), generator=g, device=device) * 0.02 + 1e-3))
    return x, ws


def int8_group_check(x, ws, label):
    """One ``int8_matmul_group`` call against each weight's plain version (f32
    on the same values), held as ``int8_check`` holds one product: repeats
    bit-identical, TOL_INT8, one decode entry launch, one product counted a
    weight → max |err|, or raise."""
    import torch

    from dynamo_tpu_torch.ops import int8_matmul as im

    before = (im.launches, im.decode_launches)
    outs = im.int8_matmul_group(x, ws)
    again = im.int8_matmul_group(x, ws)
    torch.cuda.synchronize()
    if (im.launches, im.decode_launches) != (before[0] + 2 * len(ws), before[1] + 2):
        raise RuntimeError(f"int8 group {label}: two calls counted "
                           f"{im.launches - before[0]} products and "
                           f"{im.decode_launches - before[1]} decode entry kernels")
    rtol, c = TOL_INT8["bfloat16"]
    worst = 0.0
    for o, a, (w, s) in zip(outs, again, ws):
        if not torch.equal(o, a):
            raise RuntimeError(f"int8 group {label}: two calls on the same inputs differ")
        ref = im.int8_matmul_ref(x.float(), w, s.float(), out_f32=True)
        absref = (x.float().abs() @ w.float().abs()) * s.float().abs()
        if o.shape != ref.shape or o.dtype != x.dtype or not torch.isfinite(o).all():
            raise RuntimeError(f"int8 group {label}: output {o.dtype} {tuple(o.shape)}")
        diff = (o.float() - ref).abs()
        excess = float((diff - rtol * ref.abs() - c * absref).max())
        if excess > 0:
            raise RuntimeError(f"int8 group {label}: {tuple(w.shape)} disagrees with its plain "
                               f"version by {excess:.3e} beyond the tolerance")
        worst = max(worst, float(diff.max()))
    return worst


INT8_M = (1, 8, 16, 32, 64, 128, 256)  # rows at every llama-8b shape: decode buckets, verify
INT8_PREFILL_M = (512, 2048)           # prefill chunks, at w_gate/w_up and w_down


def int8_substep(by: dict, M: int, shapes: dict = INT8_SHAPES) -> dict:
    """One llama-8b substep's 225 products at M rows (of ``shapes``: the
    whole model's, or a tp rank's shards), summed from the cases' times
    (calls per substep x each shape's time)."""
    return {k: sum(by[f"{name}_M{M}_bfloat16"][k] * calls
                   for name, (_, _, calls) in shapes.items())
            for k in ("ms", "plain_ms", "library_ms", "dequant_ms", "bound_ms")}


def int8_substep_grouped(by: dict, M: int, tp: bool = False) -> dict:
    """One llama-8b substep's 225 products at M <= 8 rows as the model
    calls them (of a tp=2 rank's shards with ``tp``), summed from the cases'
    times: per layer the q/k/v group, wo, the gate/up group and w_down,
    then lm_head."""
    pre = "tp2_" if tp else ""
    parts = [(f"group_{pre}qkv", 32), (f"group_{pre}gate_up", 32),
             (f"{pre}wo" if tp else "wq_wo", 32), (f"{pre}w_down", 32), (f"{pre}lm_head", 1)]
    return {k: sum(by[f"{name}_M{M}_bfloat16"][k] * n for name, n in parts)
            for k in ("ms", "plain_ms", "library_ms", "bound_ms")}


def int8_kernel_phase(device, card_line):
    """The int8 product against its plain version at every llama-8b decode
    shape for M in ``INT8_M`` (bf16 x; lm_head with f32 logits out; M <= 8
    on the decode kernel, more rows on the wide entry), w_gate/w_up and
    w_down at ``INT8_PREFILL_M``, the odd shape in bf16 and f32, and wq in
    f32: bit-identical repeats, tolerance TOL_INT8, the route each call
    takes, and kernel, plain, library (bf16 ``torch.matmul``), dequantize +
    ``torch.matmul`` (the prefill route, inline) and bound times. First the
    wide entry's blocks per SM, held to the wrapper's split plan's table."""
    import torch

    from dynamo_tpu_torch.ops import int8_matmul as im

    got = {tile: im.wide_blocks_per_sm(tile) for tile in im.WIDE_ROW_TILES}
    if set(got.values()) != {im.WIDE_BLOCKS_PER_SM}:
        raise RuntimeError(f"int8 wide entry: blocks per SM by row tile {got}, the split plan "
                           f"assumes {im.WIDE_BLOCKS_PER_SM}")
    log(f"int8 wide entry: blocks per SM by row tile {got} (occupancy of the built kernel, as "
        f"the split plan assumes)")
    got = im.decode_blocks_per_sm()
    if got != im.DECODE_BLOCKS_PER_SM:
        raise RuntimeError(f"int8 decode entry: {got} blocks per SM, the cluster plan assumes "
                           f"{im.DECODE_BLOCKS_PER_SM}")
    log(f"int8 decode entry: {got} blocks per SM (occupancy of the built kernel, as the cluster "
        "plan assumes)")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    cases = [(name, M, K, N, "bfloat16", name == "lm_head")
             for name, (K, N, _) in INT8_SHAPES.items() for M in INT8_M]
    cases += [(name, M, *INT8_SHAPES[name][:2], "bfloat16", False)
              for name in ("w_gate_up", "w_down") for M in INT8_PREFILL_M]
    cases += [(INT8_ODD[0], M, INT8_ODD[1], INT8_ODD[2], dt, False)
              for M in (5, 64) for dt in ("bfloat16", "float32")]
    cases += [("wq_wo", 8, 4096, 4096, "float32", False),
              ("lm_head_bf16_scale", 8, 4096, 128256, "bfloat16", True)]
    cases += [(name, M, K, N, "bfloat16", name.endswith("lm_head"))
              for name, (K, N, _) in INT8_TP_SHAPES.items() for M in INT8_TP_M]
    results = []
    for i, (name, M, K, N, xdt, out_f32) in enumerate(cases):
        x, w, s = int8_case(M, K, N, xdt, 500 + i, device,
                            "bfloat16" if name.endswith("bf16_scale") else "float32")
        which = im.route(x, w)
        before = im.wide_launches
        err = int8_check(x, w, s, out_f32, f"{name} M={M} {xdt}")
        if im.wide_launches - before != (2 if which == "wide" else 0):
            raise RuntimeError(f"int8 {name} M={M}: route {which!r} but the wide entry counted "
                               f"{im.wide_launches - before} launches for two calls")
        ms = time_ms(lambda: im.int8_matmul(x, w, s, out_f32=out_f32), flush)
        plain_ms = time_ms(lambda: im.int8_matmul_ref(x, w, s, out_f32=out_f32), flush)
        dq = (lambda: torch.matmul(x, w.to(x.dtype)).float() * s) if out_f32 else (
            lambda: torch.matmul(x, w.to(x.dtype)) * s.to(x.dtype))
        dequant_ms = time_ms(dq, flush)
        wb = w.to(x.dtype)
        lib_ms = time_ms(lambda: torch.matmul(x, wb), flush)
        del wb
        xb = x.element_size()
        b_ms, b_by = int8_bound(M, K, N, xb, 4 if out_f32 else xb, s.element_size(), xdt)
        plan = (im.wide_plan(M, K, N) if which == "wide" else
                im.cluster_plan(K, -(-N // im.DECODE_BN)) if im.decode_entry(x, w) else
                im.split_k(K, N))
        r = {"case": f"{name}_M{M}_{xdt}", "M": M, "K": K, "N": N, "route": which,
             "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
             "dequant_ms": dequant_ms, "bound_ms": b_ms, "bound_by": b_by, "plan": plan}
        log(f"int8 {r['case']} ({K}x{N}, {which}): max_abs_err={err:.3e} (tol {TOL_INT8[xdt]}) "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
            f"dequant_ms={dequant_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) plan={plan} ({card_line})")
        results.append(r)
        del x, w, s
    for i, (name, names) in enumerate(INT8_GROUPS.items()):
        for M in INT8_GROUP_M:
            x, ws = int8_group_case(M, names, 900 + 10 * i + M, device)
            err = int8_group_check(x, ws, f"{name} M={M}")
            ms = time_ms(lambda: im.int8_matmul_group(x, ws), flush)
            split_ms = time_ms(lambda: [im._launch(x, w, s, False, M, *w.shape) for w, s in ws],
                               flush)
            plain_ms = time_ms(lambda: [im.int8_matmul_ref(x, w, s) for w, s in ws], flush)
            wbs = [w.to(x.dtype) for w, _ in ws]
            lib_ms = time_ms(lambda: [torch.matmul(x, wb) for wb in wbs], flush)
            del wbs
            K = x.shape[1]
            nbytes = sum(K * w.shape[1] + 4 * w.shape[1] + 2 * M * w.shape[1] for w, _ in ws)
            t_bytes = (nbytes + 2 * M * K) / HBM_BYTES_PER_S
            t_ops = sum(2.0 * M * K * w.shape[1] for w, _ in ws) / PEAK_OPS["bfloat16"]
            r = {"case": f"group_{name}_M{M}_bfloat16", "M": M, "K": K,
                 "N": [w.shape[1] for w, _ in ws], "route": "decode group",
                 "max_abs_err": err, "ms": ms, "split_k_ms": split_ms, "plain_ms": plain_ms,
                 "library_ms": lib_ms, "bound_ms": max(t_bytes, t_ops) * 1e3,
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                 "plan": im.cluster_plan(K, sum(-(-w.shape[1] // im.DECODE_BN) for w, _ in ws))}
            log(f"int8 {r['case']} ({K}x{r['N']}, one decode entry launch): max_abs_err={err:.3e} "
                f"kernel_ms={ms:.4f} split-K kernel per weight {split_ms:.4f} plain_ms="
                f"{plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={r['bound_ms']:.4f} "
                f"({r['bound_by']}) plan={r['plan']} ({card_line})")
            results.append(r)
            del x, ws
    torch.cuda.empty_cache()
    by = {r["case"]: r for r in results}
    substep = {M: int8_substep(by, M) for M in INT8_M if M > 1}
    for M, t in substep.items():
        log(f"int8: the 225 products of one llama-8b substep at M={M}, from the cases above: "
            f"kernel {t['ms']:.3f} ms, plain {t['plain_ms']:.3f}, library (bf16 weights) "
            f"{t['library_ms']:.3f}, dequantize + torch.matmul {t['dequant_ms']:.3f}, bound "
            f"{t['bound_ms']:.3f} ({card_line})")
    for M in INT8_GROUP_M:
        for tp in (False, True):
            t = int8_substep_grouped(by, M, tp)
            substep[f"{'tp2_' if tp else ''}grouped_M{M}"] = t
            log(f"int8: {'one tp=2 rank' if tp else 'one llama-8b substep'}'s 225 products at "
                f"M={M} as the model calls them (q/k/v and gate/up grouped), from the cases "
                f"above: kernel {t['ms']:.3f} ms, plain {t['plain_ms']:.3f}, library (bf16 "
                f"weights) {t['library_ms']:.3f}, bound {t['bound_ms']:.3f} ({card_line})")
    for M in INT8_TP_M:
        t = int8_substep(by, M, INT8_TP_SHAPES)
        substep[f"tp2_M{M}"] = t
        log(f"int8: one tp=2 rank's 225 products of a llama-8b substep at M={M} (its shards): "
            f"kernel {t['ms']:.3f} ms, plain {t['plain_ms']:.3f}, library (bf16 weights) "
            f"{t['library_ms']:.3f}, dequantize + torch.matmul {t['dequant_ms']:.3f}, bound "
            f"{t['bound_ms']:.3f} ({card_line})")
    return results, substep


DECODE_PHASES = ("decode_dispatch", "drain_sync", "drain_ready", "emit")


def int8_rows_route(M: int) -> str:
    """The route of a bf16 int8 product of M rows at the presets' widths
    (K % 8 == 0, N % 16 == 0, weights 16-byte aligned): ``route``'s rule."""
    from dynamo_tpu_torch.ops.int8_matmul import SMALL_M

    return "kernel" if M <= SMALL_M else "wide"


def prefill_chunk_buckets(lens, bs: int = 16) -> list[int]:
    """The T bucket of every prefill dispatch that cold single-row prefills
    of ``lens`` tokens make at the engine's defaults (the "fine" ladder,
    tail split on, max_prefill_tokens 2048): each suffix's chunk plan
    (``EngineArgs.plan_prefill_chunks``; max_prefill_tokens chunks past
    it), each chunk padded to its rung."""
    from dynamo_tpu_torch.engine.config import EngineArgs

    args = EngineArgs(block_size=bs)
    out = []
    for n in lens:
        m = args.max_prefill_tokens
        chunks = (args.plan_prefill_chunks(n) if n <= m
                  else [min(m, n - pos) for pos in range(0, n, m)])
        out += [args.bucket_prefill(c) for c in chunks]
    return out


def int8_expected(cfg, lens, substeps: int, bs: int = 16,
                  buckets: dict | None = None) -> tuple[int, int, int]:
    """int8 calls a burst makes on each route (decode kernel, prefill route,
    wide entry): 7 per layer plus lm_head per forward pass. Decode substeps
    run at batch bucket 8 (the decode kernel), or at the buckets of
    ``buckets`` ({bucket rows: substeps}); each single-row prefill chunk of
    a cold prompt (``prefill_chunk_buckets``), padded to T tokens, runs its
    layer products on T's route and its last-token head (1 row) on the
    decode kernel. A tied head (the int8 embedding as ``emb.T``) is none of
    these: it launches the tied entry once per forward (``tied_launches``)."""
    per_pass = 7 * cfg.num_layers
    head = 0 if cfg.tie_embeddings else 1
    n = {"kernel": 0, "prefill": 0, "wide": 0}
    for rows, steps in (buckets or {8: substeps}).items():
        n[int8_rows_route(rows)] += (per_pass + head) * steps
    for T in prefill_chunk_buckets(lens, bs):
        n[int8_rows_route(T)] += per_pass
        n["kernel"] += head
    return n["kernel"], n["prefill"], n["wide"]


def decode_expected(cfg, lens, substeps: int, bs: int = 16, buckets: dict | None = None) -> int:
    """Kernels the decode entry launches in a burst on the card (bf16 x at
    the presets' aligned widths): per forward of a decode-route bucket 4 a
    layer (q/k/v as one group, wo, gate/up as one group, w_down) and
    lm_head, and each prefill chunk's last-token head (with its layer
    products when the chunk is that short). A tied head is none of these."""
    per_pass = 4 * cfg.num_layers
    head = 0 if cfg.tie_embeddings else 1
    n = sum((per_pass + head) * steps for rows, steps in (buckets or {8: substeps}).items()
            if int8_rows_route(rows) == "kernel")
    for T in prefill_chunk_buckets(lens, bs):
        n += (per_pass if int8_rows_route(T) == "kernel" else 0) + head
    return n


def verify_per_forward(layers: int, cuda: bool, int8: bool, stepwise: bool = False) -> tuple:
    """Kernel-wrapper calls of one verify forward, in graphs.COUNTERS order
    (attention, int8 decode-route products, int8 prefill route, int8 tied
    head, int8 wide entry, decode entry launches). A fused or tree pass's
    forward runs B x S1 > 8 rows (the wide entry); a stepwise pass's
    forwards run B = 8 rows (the decode route: its 7 products a layer are 4
    decode entry launches, q/k/v and gate/up grouped)."""
    i8 = (7 * layers + 1) if cuda and int8 else 0
    groups = (4 * layers + 1) if cuda and int8 and stepwise else 0
    return (layers if cuda else 0, i8 if stepwise else 0, 0, 0, 0 if stepwise else i8, groups)


def int8_counts() -> tuple[int, int, int, int]:
    """(attention, int8 kernel, int8 prefill route, int8 wide entry) launches
    so far."""
    from dynamo_tpu_torch.ops import int8_matmul as im
    from dynamo_tpu_torch.ops import paged_attention as pa

    return pa.launches, im.launches, im.prefill_launches, im.wide_launches


def zero_counts() -> None:
    """Every kernel wrapper's launch count to 0."""
    from dynamo_tpu_torch.ops import int8_matmul as im
    from dynamo_tpu_torch.ops import paged_attention as pa

    pa.launches = im.launches = im.prefill_launches = im.tied_launches = im.wide_launches = 0
    im.decode_launches = 0


def warm_prefill_graphs(runner, tag: str, card_line: str) -> dict:
    """``runner.warm_prefills()`` → the prefill graphs' count, capture
    seconds and pool bytes (the worker's counters), logged beside the whole
    pool."""
    from dynamo_tpu_torch.worker.__main__ import prefill_graph_counters

    t0 = time.perf_counter()
    n = runner.warm_prefills()
    c = prefill_graph_counters(runner.graphs)
    st = {"graphs": c["prefill_graphs"], "capture_s": c["prefill_capture_s"],
          "pool_bytes": c["prefill_pool_bytes"], "captured_now": n,
          "wall_s": time.perf_counter() - t0}
    g = runner.graphs
    log(f"{tag}: {st['graphs']} prefill graphs (rows, T, W: "
        f"{[k[1:4] for k in (g.shapes if g else []) if k[0] == 'prefill']}) captured ahead of "
        f"traffic in {st['capture_s']:.2f}s ({st['wall_s']:.2f}s wall), adding "
        f"{st['pool_bytes'] / 2**20:.1f} MiB to a graph pool of "
        f"{(g.pool_bytes() if g else 0) / 2**20:.1f} MiB ({card_line})")
    return st


def prefill_inputs(runner, shape, seed: int, first_block: int = 1) -> tuple:
    """Seeded operands of one prefill dispatch of ``shape`` (rows, T, W):
    each row a suffix whose length lies in T's rung (one past the rung
    below, up to T, and within the table), on blocks of its own from
    ``first_block`` on; odd rows start behind a cached prefix when the
    table has room. → ((toks, tables, starts, tlens), next free block)."""
    import numpy as np

    Bp, T, W = shape
    args = runner.args
    bs = args.block_size
    ladder = (0, *args.prefill_buckets)
    lo = ladder[ladder.index(T) - 1] + 1
    rng = np.random.default_rng(seed)
    toks = np.zeros((Bp, T), np.int32)
    tables = np.zeros((Bp, W), np.int32)
    starts = np.zeros((Bp,), np.int32)
    tlens = np.zeros((Bp,), np.int32)
    nxt = first_block
    for r in range(Bp):
        n = int(rng.integers(lo, min(T, W * bs) + 1))
        room = (W * bs - n) // bs
        start = int(rng.integers(1, room + 1)) * bs if r % 2 and room > 0 else 0
        nblk = -(-(start + n) // bs)
        tables[r, :nblk] = np.arange(nxt, nxt + nblk)
        nxt += nblk
        toks[r, :n] = rng.integers(1, runner.cfg.vocab_size, n)
        starts[r], tlens[r] = start, start + n
    return (toks, tables, starts, tlens), nxt


def prefill_graph_checks(runner, tag: str, card_line: str) -> dict:
    """For every captured prefill shape, two seeded waves of that shape
    back to back as graph replays, then op by op from the same cache (the
    touched blocks restored between, as ``graph_vs_eager`` does): both
    waves' logits and the KV pages they write (block 0, the garbage sink,
    aside) must be bit-identical. The first wave's logits are read after
    the second replay, which overwrites the graph's static output: the
    copy each dispatch takes is what keeps them. The two waves' greedy
    first tokens must differ. → shapes checked and seconds (0 on the CPU,
    where no graph is captured)."""
    import torch

    g = runner.graphs
    shapes = [k[1:4] for k in (g.shapes if g else []) if k[0] == "prefill" and not k[4]]
    t0 = time.perf_counter()
    for shape in shapes:
        a, nxt = prefill_inputs(runner, shape, 7000 + sum(shape))
        b, _ = prefill_inputs(runner, shape, 8000 + sum(shape), nxt)
        blocks = torch.tensor(sorted({0, *a[1].ravel().tolist(), *b[1].ravel().tolist()}),
                              device=runner.device)
        pages = [t for t in runner.cache if t is not None]
        saved = [t[:, blocks].clone() for t in pages]
        runs = []
        for eager in (False, True):
            for t, v in zip(pages, saved):
                t[:, blocks] = v
            la = runner.prefill_batch(*a, eager=eager)
            lb = runner.prefill_batch(*b, eager=eager)
            runs.append((la, lb, [t[:, blocks[1:]].clone() for t in pages]))
        for t, v in zip(pages, saved):
            t[:, blocks] = v
        torch.cuda.synchronize()
        (ga, gb, gs), (ea, eb, es) = runs
        if not (torch.equal(ga, ea) and torch.equal(gb, eb)):
            raise RuntimeError(f"{tag}: prefill graph {shape} logits differ from eager ones")
        if not all(torch.equal(x, y) for x, y in zip(gs, es)):
            raise RuntimeError(f"{tag}: prefill graph {shape} wrote other KV pages than eager")
        if torch.equal(ga.argmax(-1), gb.argmax(-1)):
            raise RuntimeError(f"{tag}: prefill check {shape}: both waves have the same "
                               "greedy first tokens")
    st = {"shapes": len(shapes), "seconds": time.perf_counter() - t0}
    if shapes:
        log(f"{tag}: all {len(shapes)} prefill graphs bit-identical to eager (two waves of each "
            f"shape back to back, logits and KV pages), in {st['seconds']:.1f}s ({card_line})")
    return st


PREFILL_TIMED = (64, 512, 2048)  # chunk lengths whose prefill graph is timed alone


def prefill_bound(runner, T: int) -> dict:
    """The least time one cold prefill chunk of T tokens (one row, from
    position 0) can take: the larger of its FLOPs at the bf16 dense peak
    and its bytes at 3.35 TB/s. FLOPs: 2 per layer parameter per token, the
    head's 2·d·V for the last token only (prefill samples no other row),
    and QK^T plus PV over the T(T+1)/2 causal pairs of every layer. Bytes:
    the layers' and the head's weights, T embedding rows read, T tokens' K
    and V written into every layer's pages and one row of f32 logits.
    → {bound_ms, bound_by}."""
    cfg, p = runner.cfg, runner.params

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in _leaves(tree))

    d, V, L = cfg.hidden_size, cfg.vocab_size, cfg.num_layers
    head = d * V
    layer_params = cfg.param_count() - V * d - d - (0 if cfg.tie_embeddings else head)
    flops = 2 * T * layer_params + 2 * head + 2 * L * cfg.q_size * T * (T + 1)
    kv_elt = next(t for t in runner.cache if t is not None).element_size()
    moved = (nbytes(p["layers"]) + nbytes(p.get("lm_head", p["embed"]))
             + nbytes(p["final_norm"]) + T * nbytes(p["embed"]) // V
             + T * L * 2 * cfg.kv_size * kv_elt + V * 4)
    flops_ms = flops / PEAK_OPS["bfloat16"] * 1e3
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(flops_ms, bytes_ms),
            "bound_by": "operations" if flops_ms > bytes_ms else "bytes"}


def prefill_timing(runner, tag: str, card_line: str) -> dict:
    """Device time of one prefill chunk of T tokens (PREFILL_TIMED, one row,
    a cold prompt's table bucket) as its graph replay and op by op, median
    of 5 CUDA-event timings after one warm run, each behind a short spin
    so that the host's packing hides; the bound is ``prefill_bound``'s.
    The cache is restored after. → {T: numbers}."""
    import numpy as np
    import torch

    args, cfg = runner.args, runner.cfg
    pages = [t for t in runner.cache if t is not None]
    out = {}
    for T in PREFILL_TIMED:
        nblk = -(-T // args.block_size)
        W = args.bucket_table(nblk)
        rng = np.random.default_rng(T)
        toks = rng.integers(1, cfg.vocab_size, (1, T)).astype(np.int32)
        tables = np.zeros((1, W), np.int32)
        tables[0, :nblk] = np.arange(1, nblk + 1)
        inp = (toks, tables, np.zeros((1,), np.int32), np.full((1,), T, np.int32))
        blocks = torch.arange(0, nblk + 1, device=runner.device)
        saved = [t[:, blocks].clone() for t in pages]
        res = {}
        for name, eager in (("ms", False), ("plain_ms", True)):
            runner.prefill_batch(*inp, eager=eager)
            times = []
            for _ in range(5):
                torch.cuda._sleep(SPIN_CYCLES)
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                runner.prefill_batch(*inp, eager=eager)
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b))
            res[name] = statistics.median(times)
        for t, v in zip(pages, saved):
            t[:, blocks] = v
        res.update(W=W, **prefill_bound(runner, T))
        out[T] = res
        log(f"{tag}: prefill chunk T={T} (1 row, W={W}): {res['ms']:.3f} ms as its graph, "
            f"{res['plain_ms']:.3f} ms op by op, bound {res['bound_ms']:.3f} ms "
            f"({res['bound_by']}) ({card_line})")
    return out


async def main_path(card_line: str, preset: str = "llama-8b", device: str = "cuda",
                    quant: str = "none", kv_quant: str = "none", wide: bool = False):
    """The burst through ``run --in batch:``'s pipeline. The bf16 run
    (quant "none") also serves the prefix-hit repeat, the profiled pass and
    the graph phase; an int8 run times one replay and profiles it, and with
    ``wide`` then runs phase 4c (``wide_phase``) on its weights' first
    ``CUT_LAYERS`` layers."""
    import numpy as np
    import torch

    from dynamo_tpu_torch.llm.protocols import CompletionRequest
    from dynamo_tpu_torch.ops import int8_matmul as im
    from dynamo_tpu_torch.run.__main__ import build_pipeline, parse_args
    from dynamo_tpu_torch.runtime.engine import Context

    tag = "main" if quant == "none" else f"main-int8-kv{kv_quant}"
    args = parse_args(["--in", "batch:-", "--preset", preset, "--dtype", "bfloat16",
                       "--device", device, *ENGINE_ARGV])
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    pipe = await build_pipeline(args, quant=quant, kv_quant=kv_quant)
    engine = pipe.engine
    runner = engine.runner
    torch.cuda.synchronize()
    log(f"{tag}: {preset} pipeline up in {time.perf_counter() - t0:.1f}s "
        f"(random {'int8' if quant == 'int8' else 'bf16'} weights made on the card, "
        f"{kv_quant} KV pages), pipeline_depth {engine.args.effective_pipeline_depth}")
    cfg = engine.cfg
    g = runner.graphs
    n = runner.warm_windows(("greedy", "simple"), (0,))
    log(f"{tag}: {n} window graphs captured ahead of traffic in {g.capture_s:.2f}s "
        f"(shapes B, W, L, K, mode, top_n: {g.shapes}), graph pool "
        f"{g.pool_bytes() / 2**20:.1f} MiB ({card_line})")
    prefill_warm = warm_prefill_graphs(runner, tag, card_line)
    lens, temps, max_tokens = BURST_LENS, BURST_TEMPS, BURST_TOKENS
    prompts = burst_prompts()

    async def one(i, prompt, temp, seed):
        req = CompletionRequest.parse({
            "model": pipe.card.name, "prompt": prompt, "max_tokens": max_tokens,
            "temperature": temp, "seed": seed, "ignore_eos": True, "logprobs": 0,
        })
        t_start = time.perf_counter()
        t_first = None
        gen = None
        async for g, _chunk in pipe.run(req, Context()):
            if t_first is None:
                t_first = time.perf_counter() - t_start
            gen = g
        return {"i": i, "ttft_s": t_first, "resp": gen.final_response(),
                "tokens": list(gen.lp_tokens), "logprobs": list(gen.lp_values),
                "ref": reference_entry(gen, t_first)}

    async def burst(label):
        """The 8 requests at once; every count zeroed just before, read just
        after, once the engine has drained its queue."""
        steps0, phases0 = _counters(engine)
        replays0, eager0 = runner.graphs.replays, runner.eager_windows
        eager_pre0 = runner.eager_prefills
        counts0 = runner.graphs.replay_counts()
        zero_counts()
        t0 = time.perf_counter()
        outs = await asyncio.gather(*(one(i, p, t, 1000 + i)
                                      for i, (p, t) in enumerate(zip(prompts, temps))))
        wall = time.perf_counter() - t0
        while engine.busy():
            await asyncio.sleep(0.001)
        launches, i8, i8_prefill, i8_wide = int8_counts()
        i8_decode = im.decode_launches
        steps1, phases1 = _counters(engine)
        substeps = steps1 - steps0
        phase = {k: v - phases0.get(k, 0.0) for k, v in phases1.items()}
        for o in outs:
            usage, choice = o["resp"]["usage"], o["resp"]["choices"][0]
            if usage["completion_tokens"] != max_tokens or choice["finish_reason"] != "length":
                raise RuntimeError(f"{label} request {o['i']}: {usage['completion_tokens']} "
                                   f"tokens, finish {choice['finish_reason']!r}")
            if len(o["tokens"]) != max_tokens or not all(
                    np.isfinite(lp) and lp <= 0.0 for lp in o["logprobs"]):
                raise RuntimeError(f"{label} request {o['i']}: bad token/logprob stream")
            if not all(0 <= t < cfg.vocab_size for t in o["tokens"]):
                raise RuntimeError(f"{label} request {o['i']}: token id out of range")
        if launches != cfg.num_layers * substeps or substeps == 0:
            raise RuntimeError(f"{label}: kernel launches {launches} != layers "
                               f"{cfg.num_layers} x substeps {substeps}")
        want_i8 = int8_expected(cfg, lens, substeps) if quant == "int8" else (0, 0, 0)
        if (i8, i8_prefill, i8_wide) != want_i8:
            raise RuntimeError(f"{label}: int8_matmul launches (kernel, prefill route, wide "
                               f"entry) {(i8, i8_prefill, i8_wide)} != {want_i8} for {substeps} "
                               "substeps")
        want_decode = decode_expected(cfg, lens, substeps) if (
            quant == "int8" and device == "cuda") else 0
        if i8_decode != want_decode:
            raise RuntimeError(f"{label}: the int8 decode entry launched {i8_decode} kernels for "
                               f"{i8} decode-route products; want {want_decode}")
        eager = runner.eager_windows - eager0
        if eager:
            raise RuntimeError(f"{label}: {eager} K-step windows ran eagerly on the card")
        if runner.eager_prefills != eager_pre0:
            raise RuntimeError(f"{label}: {runner.eager_prefills - eager_pre0} prefill "
                               "dispatches ran eagerly on the card")
        decode_s = sum(phase.get(k, 0.0) for k in DECODE_PHASES)
        total_tokens = sum(o["resp"]["usage"]["completion_tokens"] for o in outs)
        st = {"launches": launches, "int8_launches": i8, "int8_prefill_launches": i8_prefill,
              "int8_wide_launches": i8_wide, "int8_decode_launches": i8_decode,
              "substeps": substeps, "wall_s": wall,
              "tokens_per_s": total_tokens / wall, "substep_ms": decode_s / substeps * 1e3,
              "decode_s": decode_s, "host_blocked": phase.get("drain_sync", 0.0) / decode_s,
              "prefill_dispatch_s": phase.get("prefill_dispatch", 0.0),
              "replays": runner.graphs.replays - replays0,
              "prefill_replays": {str(k[1:4]): n - counts0.get(k, 0) for k, n in
                                  runner.graphs.replay_counts().items()
                                  if k[0] == "prefill" and n > counts0.get(k, 0)},
              "ttft_s": [o["ttft_s"] for o in outs]}
        log(f"{tag}[{label}]: 8 requests, {total_tokens} completion tokens in {wall:.3f}s → "
            f"{st['tokens_per_s']:.1f} tokens/s ({card_line})")
        for o in outs:
            log(f"{tag}[{label}]: request {o['i']} prompt {lens[o['i']]} tokens, temperature "
                f"{temps[o['i']]}: TTFT {o['ttft_s'] * 1e3:.1f} ms ({card_line})")
        log(f"{tag}[{label}]: decode {substeps} substeps, {st['substep_ms']:.3f} ms per substep "
            f"(host time in decode phases {decode_s:.3f}s / substeps; batch of 8), host blocked "
            f"on fetches {100 * st['host_blocked']:.1f}% of it, {st['replays']} graph replays "
            f"({card_line})")
        log(f"{tag}[{label}]: prefill dispatch {st['prefill_dispatch_s']:.3f}s of host time "
            f"for the 8 prompts ({len(prefill_chunk_buckets(lens))} chunks, each a graph replay, "
            f"no eager prefill; replays by (rows, T, W) {st['prefill_replays']}) ({card_line})")
        log(f"{tag}[{label}]: phases " + json.dumps({k: round(v, 4) for k, v in phase.items()}))
        log(f"{tag}[{label}]: paged_attention launches {launches} = {cfg.num_layers} layers x "
            f"{substeps} substeps; int8_matmul products {i8} on the decode route ({i8_decode} "
            f"decode entry kernels), {i8_wide} on the wide entry, {i8_prefill} on the prefill "
            "route")
        return outs, st

    first, st2 = await burst("depth2")
    param_bytes = sum(t.numel() * t.element_size() for t in _leaves(runner.params))
    weight_bound_ms = param_bytes / HBM_BYTES_PER_S * 1e3
    log(f"{tag}: weight-stream bound {weight_bound_ms:.3f} ms per substep "
        f"({param_bytes / 1e9:.2f} GB / 3.35 TB/s) ({card_line})")
    log(f"{tag}: {g.captured} window graphs in all, captured in {g.capture_s:.2f}s, graph pool "
        f"{g.pool_bytes() / 2**20:.1f} MiB, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card_line})")

    # The same burst unpipelined, from an empty prefix cache (so every
    # prefill takes the same path): the streams must not change.
    engine.clear_kv_blocks()
    engine.args.pipeline_depth = 0
    second, st0 = await burst("depth0")
    engine.args.pipeline_depth = 2
    for a, b in zip(first, second):
        if a["tokens"] != b["tokens"] or a["logprobs"] != b["logprobs"]:
            raise RuntimeError(f"{tag} request {a['i']}: depth 2 and depth 0 streams differ")
    log(f"{tag}: all 8 token and logprob streams identical at pipeline_depth 2 and 0")
    stats = {"launches": st2["launches"], "int8_launches": st2["int8_launches"],
             "int8_decode_launches": st2["int8_decode_launches"],
             "int8_prefill_launches": st2["int8_prefill_launches"],
             "int8_wide_launches": st2["int8_wide_launches"], "substeps": st2["substeps"],
             "tokens_per_s": st2["tokens_per_s"], "substep_ms": st2["substep_ms"],
             "host_blocked": st2["host_blocked"], "ttft_s": st2["ttft_s"],
             "depth0": {k: st0[k] for k in ("substeps", "tokens_per_s", "substep_ms",
                                             "host_blocked", "ttft_s")},
             "weight_bound_ms": weight_bound_ms, "graphs": g.captured,
             "capture_s": g.capture_s, "graph_pool_bytes": g.pool_bytes(),
             "replays": st2["replays"], "prefill_dispatch_s": st2["prefill_dispatch_s"],
             "prefill_replays": st2["prefill_replays"], "prefill_graphs": prefill_warm,
             "prefill_timing": prefill_timing(runner, tag, card_line) if quant == "none" else {},
             "max_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    reference = {"burst": [o["ref"] for o in first]}
    if quant == "none" or kv_quant == "int8":
        # The requests phase 11 prefills remotely, again on the prefixes the
        # depth-0 pass cached (request 7 first: phase 7's repeat). A remote
        # prefill is admitted as the same prefix hit, so these are the
        # references of phases 7 and 11.
        repeats = {}
        for i in sorted(REMOTE, key=lambda i: i != 7):
            repeats[i] = await one(i, prompts[i], temps[i], 1000 + i)
        reference["repeats"] = {i: r["ref"] for i, r in repeats.items()}
    if quant == "none":
        repeat = repeats[7]
        drift = max(abs(a - b) for a, b in zip(repeat["logprobs"], first[7]["logprobs"]))
        log(f"main: request 7 again on its cached prefix: tokens "
            f"{'equal to' if repeat['tokens'] == first[7]['tokens'] else 'not equal to'} its "
            f"cold pass, max |logprob - cold pass| {drift:.3g}, TTFT "
            f"{repeat['ttft_s'] * 1e3:.1f} ms ({card_line})")
        reference["repeat"] = repeat["ref"]
        stats["device_busy_share"] = await busy_pass(engine, one, prompts, temps, first,
                                                     card_line)
        stats.update(window_phase(engine, card_line))
        stats["sweep"] = await sweep_phase(engine, card_line, device)
    else:
        stats.update(replay_phase(engine, card_line, tag))
    # The wide run (int8 weights, bf16 pages) runs the int8 products that
    # the int8-page run holds to eager already.
    if not wide:
        stats["prefill_vs_eager"] = prefill_graph_checks(runner, tag, card_line)
    if wide:
        t1 = time.perf_counter()
        stats["wide"] = await wide_phase(card_line, pipe, device)
        log(f"phase 4c (wide): {time.perf_counter() - t1:.1f}s")
    await engine.stop()
    del pipe, engine, runner
    torch.cuda.empty_cache()
    return stats, reference


# -- phase 4s: the SLA profile swept on the main path's engine -----------------

SWEEP_BATCHES = (1, 2, 4, 8)                  # concurrent sequences, up to max_num_seqs
SWEEP_PROMPT_LENS = (64, 128, 256, 512, 1024)  # prompt tokens of the TTFT samples
SWEEP_GEN = 96  # tokens a decode sample generates: the JAX tool's default


async def sweep_phase(engine, card_line: str, device: str = "cuda") -> dict:
    """Phase 4s: ``planner.profile_sweep.sweep`` over the main path's engine
    (its windows captured, its cache cleared) → the batch → ITL / tokens/s
    and prompt length → TTFT curves, saved as the npz phase 7's workers
    ship in their model cards (``--sla-profile``). Every sample finite and
    positive, tokens/s at the largest batch above that at 1, no window
    eager, attention launches num_layers x the sweep's substeps (0 on the
    CPU, where the plain version runs)."""
    import tempfile

    import numpy as np

    from dynamo_tpu_torch.planner.interpolate import save_profile
    from dynamo_tpu_torch.planner.profile_sweep import card_meta, sweep

    runner = engine.runner
    engine.clear_kv_blocks()
    steps0, _ = _counters(engine)
    eager0, eager_pre0 = runner.eager_windows, runner.eager_prefills
    zero_counts()
    t0 = time.perf_counter()
    decode, prefill = await sweep(engine, SWEEP_BATCHES, SWEEP_PROMPT_LENS, SWEEP_GEN,
                                  log=lambda m: log(f"sweep: {m} ({card_line})"))
    wall = time.perf_counter() - t0
    while engine.busy():
        await asyncio.sleep(0.001)
    launches = int8_counts()[0]
    substeps = _counters(engine)[0] - steps0
    cfg = engine.cfg
    samples = np.concatenate([decode.itl_ms, decode.tok_s, prefill.ttft_ms, prefill.tok_s])
    if not (np.all(np.isfinite(samples)) and np.all(samples > 0)):
        raise RuntimeError(f"sweep: non-finite or non-positive samples {samples.tolist()}")
    lo, hi = min(SWEEP_BATCHES), max(SWEEP_BATCHES)
    if not decode.throughput_at(hi) > decode.throughput_at(lo):
        raise RuntimeError(f"sweep: tokens/s at B={hi} {decode.throughput_at(hi):.1f} is not "
                           f"above B={lo}'s {decode.throughput_at(lo):.1f}")
    if (runner.eager_windows, runner.eager_prefills) != (eager0, eager_pre0):
        raise RuntimeError(f"sweep: {runner.eager_windows - eager0} windows and "
                           f"{runner.eager_prefills - eager_pre0} prefills ran eagerly")
    want = cfg.num_layers * substeps if device == "cuda" else 0
    if launches != want or substeps <= 0:
        raise RuntimeError(f"sweep: attention launches {launches} != {want} "
                           f"({cfg.num_layers} layers x {substeps} substeps)")
    path = os.path.join(tempfile.mkdtemp(prefix="sla-profile-"), "profile.npz")
    save_profile(path, decode=decode, prefill=prefill,
                 meta={"model": cfg.name, "device": device, "dtype": engine.args.dtype,
                       "decode_steps": engine.args.decode_steps, "gen_len": SWEEP_GEN,
                       **card_meta()})
    log("sweep: decode curve (batch: tokens/s, ITL ms) " + ", ".join(
        f"{b:.0f}: {t:.1f}, {i:.2f}" for b, t, i in zip(decode.batch, decode.tok_s,
                                                        decode.itl_ms)) + f" ({card_line})")
    log("sweep: prefill curve (prompt tokens: TTFT ms) " + ", ".join(
        f"{n:.0f}: {t:.2f}" for n, t in zip(prefill.prompt_len, prefill.ttft_ms))
        + f" ({card_line})")
    log(f"sweep: lone TTFT {min(prefill.ttft_ms):.1f}-{max(prefill.ttft_ms):.1f} ms at "
        f"{min(SWEEP_PROMPT_LENS)}-{max(SWEEP_PROMPT_LENS)} prompt tokens, each prefill chunk "
        f"a graph replay ({runner.eager_prefills - eager_pre0} eager) ({card_line})")
    depth0 = await lone_ttft_depth0(engine, card_line)
    log(f"sweep: {substeps} substeps, attention launches {launches} (= {want}), no eager "
        f"window, {wall:.1f}s; profile written to {path}")
    return {"path": path, "wall_s": wall, "substeps": substeps, "launches": launches,
            "batch": decode.batch.tolist(), "tok_s": decode.tok_s.tolist(),
            "itl_ms": decode.itl_ms.tolist(), "prompt_len": prefill.prompt_len.tolist(),
            "ttft_ms": prefill.ttft_ms.tolist(), "gen_len": SWEEP_GEN,
            "lone_ttft_ms_depth0": depth0}


async def lone_ttft_depth0(engine, card_line: str) -> dict:
    """The sweep's lone TTFT (one request of 2 tokens on an idle engine,
    after a warm one of the same length) at pipeline depth 0, beside the
    sweep's own at the engine's depth 2. At depth 2 the engine dispatches a
    K-step window behind the first token's fetch and harvests that fetch
    only when it next drains; at depth 0 it waits for the fetch before
    planning a window. → {prompt tokens: ms}."""
    import numpy as np

    from dynamo_tpu_torch.llm.protocols import PreprocessedRequest
    from dynamo_tpu_torch.runtime.engine import Context

    rng = np.random.default_rng(1)
    out = {}
    depth = engine.args.pipeline_depth
    engine.args.pipeline_depth = 0
    try:
        for n in SWEEP_PROMPT_LENS:
            for warm in (True, False):
                r = PreprocessedRequest(model=engine.cfg.name, token_ids=rng.integers(
                    1, engine.cfg.vocab_size - 1, size=n).tolist())
                r.sampling.temperature = 0.0
                r.stop.max_tokens = 2
                r.stop.ignore_eos = True
                t0, first = time.perf_counter(), None
                async for item in engine.generate(r, Context()):
                    if item.get("token_ids") and first is None:
                        first = time.perf_counter() - t0
                while engine.busy():
                    await asyncio.sleep(0.001)
                if not warm:
                    out[n] = first * 1e3
    finally:
        engine.args.pipeline_depth = depth
    log("sweep: lone TTFT at pipeline depth 0: " + ", ".join(
        f"{n}: {ms:.1f}" for n, ms in out.items()) + f" ms ({card_line})")
    return out


# -- phase 4c: the wide int8 entry on a serving path --------------------------

WIDE_SEQS = 128                        # max_num_seqs: decode buckets 8, 32 and 128
WIDE_SAMPLED = range(7, WIDE_SEQS, 16)  # 8 rows at temperature 0.7, the rest greedy
WIDE_KV_BLOCKS = 4800                  # 128 rows of up to 512 + 64 tokens, and margin
WIDE_WINDOW_LENS = (64, 96, 128)       # prompt tokens of the timing runner's rows


def wide_requests() -> list[dict]:
    """128 seeded completions: byte-token prompts of 64-512 tokens, 64
    tokens each, 8 of them at temperature 0.7 and the rest greedy."""
    import numpy as np

    rng = np.random.default_rng(14)
    lens = rng.integers(64, 513, WIDE_SEQS)
    return [{"prompt": "".join(chr(c) for c in rng.integers(32, 127, n)),
             "temperature": 0.7 if i in WIDE_SAMPLED else 0.0, "seed": 2000 + i, "len": int(n)}
            for i, n in enumerate(lens)]


async def wide_phase(card_line: str, ref_pipe, device: str = "cuda",
                     max_tokens: int = BURST_TOKENS) -> dict:
    """Phase 4c: 4b's int8 weights (bf16 pages), their first ``CUT_LAYERS``
    layers (all of a model no deeper), in an engine of 128
    sequences at depth 2, serving ``wide_requests`` at once, so that its
    decode runs buckets 32 and 128 (8 too, when the last admissions leave
    a window to a few rows) as it fills and drains and every product above
    8 rows takes the wide entry. Holds: no eager window or
    step; int8 launches to ``int8_expected`` over the engine's substeps by
    bucket and its prefills (the wide entry's count exact); every greedy
    stream against the same request served by an engine of 8 sequences
    on the same layers (``ref_pipe``, 4b's, or one made on the cut
    weights: the decode kernel at M=8), token for token except where
    the reference's top-2 gap is under ``SPEC_GAP_TOL``. Then, on a runner
    of its own, one window at buckets 32 and 128 as a graph replay
    bit-identical to op by op, its device ms per substep (bucket 8 too) and
    one profiled replay by kernel family. ``max_tokens`` per request (64 on
    the card). → the phase's numbers."""
    import numpy as np
    import torch

    from dynamo_tpu_torch.engine.config import EngineArgs
    from dynamo_tpu_torch.engine.runner import LocalRunner
    from dynamo_tpu_torch.llm.protocols import CompletionRequest
    from dynamo_tpu_torch.run.__main__ import parse_args
    from dynamo_tpu_torch.runtime.engine import Context

    tag = "wide"
    cfg, params = ref_pipe.engine.cfg, ref_pipe.engine.runner.params
    dtype, preset = ref_pipe.engine.args.dtype, cfg.name
    cut_ref = None
    if cfg.num_layers > CUT_LAYERS:
        # The first CUT_LAYERS layers, as views of 4b's weights, and an
        # 8-sequence reference engine on them.
        cfg = cut_config(preset, CUT_LAYERS)
        params = {**params, "layers": {k: v[:CUT_LAYERS] for k, v in params["layers"].items()}}
        ref_pipe = cut_ref = await local_pipeline(
            parse_args(["--in", "batch:-", "--preset", preset, "--dtype", dtype, "--device",
                        device, *ENGINE_ARGV]), quant="int8", model=cfg, params=params)
    ref_engine = ref_pipe.engine
    cuda = device == "cuda"
    args = parse_args(["--in", "batch:-", "--preset", preset, "--dtype", dtype,
                       "--device", device, "--block-size", "16", "--num-kv-blocks",
                       str(WIDE_KV_BLOCKS), "--max-num-seqs", str(WIDE_SEQS),
                       "--max-model-len", "2048", "--decode-steps", "8"])
    t0 = time.perf_counter()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    pipe = await local_pipeline(args, quant="int8", model=cfg, params=params, start=False)
    engine, runner = pipe.engine, pipe.engine.runner
    L = cfg.num_layers
    reqs = wide_requests()

    async def one(p, r, top):
        req = CompletionRequest.parse({
            "model": p.card.name, "prompt": r["prompt"], "max_tokens": max_tokens,
            "temperature": r["temperature"], "seed": r["seed"], "ignore_eos": True,
            "logprobs": top})
        gen = None
        async for g_, _chunk in p.run(req, Context()):
            gen = g_
        return {"tokens": list(gen.lp_tokens), "logprobs": list(gen.lp_values),
                "tops": list(gen.lp_tops)}

    # Every request reaches the engine before its scheduler starts, so the
    # admission waves (and the buckets they fill) are the same on any host.
    zero_counts()
    tasks = await submit_then_start(engine, (one(pipe, r, 0) for r in reqs))
    t1 = time.perf_counter()
    log(f"{tag}: {cfg.name} int8 engine of {WIDE_SEQS} sequences on phase 4b's weights "
        f"({L} layers) up in "
        f"{t1 - t0:.1f}s, decode buckets {engine.args.decode_buckets}, pipeline_depth "
        f"{engine.args.effective_pipeline_depth}, {len(reqs)} requests submitted before its "
        "scheduler started")
    outs = await asyncio.gather(*tasks)
    wall = time.perf_counter() - t1
    while engine.busy():
        await asyncio.sleep(0.001)
    counts = int8_counts()
    by_bucket = dict(engine.decode_steps_by_bucket)
    substeps = sum(by_bucket.values())
    eager = (runner.eager_windows, runner.eager_steps)
    captured = (runner.graphs.captured, runner.graphs.capture_s) if runner.graphs else (0, 0.0)
    phase = _counters(engine)[1]
    for i, o in enumerate(outs):
        if len(o["tokens"]) != max_tokens or not all(
                np.isfinite(lp) and lp <= 0.0 for lp in o["logprobs"]):
            raise RuntimeError(f"{tag} request {i}: bad token/logprob stream")
    want = (L * substeps, *int8_expected(cfg, [r["len"] for r in reqs], substeps,
                                         buckets=by_bucket)) if cuda else (0, 0, 0, 0)
    if counts != want:
        raise RuntimeError(f"{tag}: launches (attention, int8 kernel, int8 prefill route, int8 "
                           f"wide entry) {counts} != {want} for substeps by bucket {by_bucket}")
    if cuda and eager != (0, 0):
        raise RuntimeError(f"{tag}: {eager[0]} windows and {eager[1]} single steps ran eagerly")
    if cuda and not {32, WIDE_SEQS} <= set(by_bucket):
        raise RuntimeError(f"{tag}: decode ran buckets {sorted(by_bucket)}, not 32 and "
                           f"{WIDE_SEQS}")
    tokens = len(reqs) * max_tokens
    decode_s = sum(phase.get(k, 0.0) for k in DECODE_PHASES)
    st = {"tokens_per_s": tokens / wall, "wall_s": wall, "substeps": substeps,
          "substeps_by_bucket": by_bucket, "launches": counts,
          "host_ms_per_substep": decode_s / max(1, substeps) * 1e3,
          "prefill_s": phase.get("prefill_dispatch", 0.0),
          "graphs_captured": captured[0], "capture_s": captured[1],
          "max_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"{tag}: {len(reqs)} requests ({len(WIDE_SAMPLED)} at temperature 0.7), {tokens} "
        f"tokens in {wall:.3f}s → {st['tokens_per_s']:.1f} tokens/s; decode substeps by bucket "
        f"{by_bucket}; host ms per substep {st['host_ms_per_substep']:.3f}; prefill "
        f"{st['prefill_s']:.2f}s of host time; {captured[0]} window graphs captured at first use "
        f"in {captured[1]:.2f}s; peak memory {st['max_mem_gib']:.2f} GiB ({card_line})")
    log(f"{tag}: launches (attention, int8 kernel, int8 prefill route, int8 wide entry) "
        f"{counts} = layers x substeps, 225 per substep on each bucket's route, prefills by "
        f"their rows")
    await engine.stop()

    # The reference: the greedy requests through 4b's engine of 8 sequences
    # (every decode product on the decode kernel), cold, with their top-2.
    ref_engine.clear_kv_blocks()
    greedy = [i for i in range(len(reqs)) if i not in WIDE_SAMPLED]
    t1 = time.perf_counter()
    refs = await asyncio.gather(*(one(ref_pipe, reqs[i], 2) for i in greedy))
    ref_wall = time.perf_counter() - t1
    n_div, gaps, drift, where = 0, [], 0.0, []
    for i, ref in zip(greedy, refs):
        o = outs[i]
        p = _first_divergence(o["tokens"], ref["tokens"])
        end = max_tokens if p is None else p
        if end:
            drift = max(drift, max(abs(a - b) for a, b in
                                   zip(o["logprobs"][:end], ref["logprobs"][:end])))
        if p is None:
            continue
        tops = sorted((lp for _tok, lp in ref["tops"][p]), reverse=True)
        gap = tops[0] - tops[1]
        if gap >= SPEC_GAP_TOL:
            raise RuntimeError(f"{tag} request {i}: its stream leaves the 8-sequence engine's at "
                               f"token {p}, where the reference's top-2 gap is {gap:.4f} >= "
                               f"{SPEC_GAP_TOL}")
        n_div += 1
        gaps.append(gap)
        where.append(p)
    st.update({"divergences": n_div, "gaps": gaps, "divergence_tokens": where,
               "max_logprob_drift": drift, "reference_wall_s": ref_wall})
    log(f"{tag}: {len(greedy)} greedy streams against the 8-sequence engine (decode kernel at "
        f"M=8, {ref_wall:.1f}s): {n_div} leave it, each where the reference's top-2 gap is "
        f"under {SPEC_GAP_TOL} (largest {max(gaps, default=0.0):.4f}, {gaps.count(0.0)} exact "
        f"ties), at tokens {sorted(where)}; max |logprob - reference| before that {drift:.4g}")

    if cuda:
        # Windows at buckets 8, 32 and 128 on a runner of their own.
        rargs = EngineArgs(model=cfg, block_size=16, num_kv_blocks=1400, max_num_seqs=WIDE_SEQS,
                           max_model_len=2048, decode_steps=8, dtype="bfloat16", device="cuda",
                           quant="int8")
        trunner = LocalRunner(rargs, params=params)
        trunner.start()
        st["replay_ms_per_substep"], st["replay_profile"] = {}, {}
        for live in (6, 32, 100):
            B = rargs.bucket_decode(live)
            kw = dict(window_inputs(trunner, "simple", 70 + live, lens=WIDE_WINDOW_LENS,
                                    live=live), top_n=0)
            if B > 8:
                graph_vs_eager(trunner, kw)
                log(f"{tag}: bucket {B} ({live} live rows) window: graph replay bit-identical to "
                    f"op by op (tokens, logprobs, KV pages, chain)")
            st["replay_ms_per_substep"][B] = replay_ms(trunner, kw)
            log(f"{tag}: bucket {B}: {st['replay_ms_per_substep'][B]:.3f} ms device time per "
                f"substep as one graph replay ({card_line})")
            if B > 8:
                st["replay_profile"][B] = profile_replay(trunner, kw, card_line,
                                                         f"bucket {B}, {live} live rows")
        trunner.stop()
        del trunner
    if cut_ref is not None:
        await cut_ref.engine.stop()
    del pipe, engine, runner, ref_pipe, ref_engine, cut_ref, params
    if cuda:
        torch.cuda.empty_cache()
    return st


# -- phase 4t: tensor parallelism, two rank processes on the card ----------------

TP_RANKS = 2
# The int8 leg's adapters (name, rank, seed) over 4 bank slots, and the
# rows of its mixed burst that name one (half the burst).
TP_LORA_SLOTS = 4
TP_ADAPTERS = [("tp-a", 8, 41), ("tp-b", 16, 42)]
TP_LORA_ROWS = {1: "tp-a", 3: "tp-b", 5: "tp-a", 7: "tp-b"}
# |logprob at tp − logprob at tp 1| on a greedy stream's tokens before it
# leaves its reference, nats. On the card a logprob is a bf16 difference
# of bf16 logits and their logsumexp; near ln 128,256 ≈ 11.8 one bf16 step
# is 2^-4, and the readings were about one step (0.0627 bf16 leg, 0.0624
# int8 leg; PERF.md §6). The bound is two steps.
TP_LP_TOL = 0.125


def tp_lora_argv() -> list[str]:
    return ["--lora-slots", str(TP_LORA_SLOTS),
            *(a for n, r, s in TP_ADAPTERS for a in ("--lora", f"{n}:{r}:{s}"))]


async def burst_reference(weights: list[str], device: str = "cuda", dtype: str = "bfloat16",
                          quant: str = "none", kv_quant: str = "none",
                          lora: bool = False) -> dict:
    """The burst in process at tp 1 (``run``'s pipeline with the main path's
    engine arguments, on the weights ``weights`` names: ``--preset`` or
    ``--model-path``) → {"plain": each request's token ids and logprobs, as
    phase 4 makes them}. With ``lora`` the engine has phase 4t's adapter
    bank and serves the burst a second time, cold, with the rows of
    ``TP_LORA_ROWS`` under their adapters ("mixed")."""
    from dynamo_tpu_torch.llm.protocols import CompletionRequest
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
    from dynamo_tpu_torch.run.__main__ import LocalPipeline, build_pipeline, parse_args
    from dynamo_tpu_torch.runtime.engine import Context
    from dynamo_tpu_torch.worker.__main__ import adapter_cards

    args = parse_args(["--in", "batch:-", *weights, "--dtype", dtype, "--device", device,
                       *ENGINE_ARGV])
    if lora:
        pipe = await local_pipeline(args, quant=quant, kv_quant=kv_quant,
                                    lora_slots=TP_LORA_SLOTS,
                                    lora_rank=max(r for _, r, _ in TP_ADAPTERS))
        for name, rank, seed in TP_ADAPTERS:
            pipe.engine.register_adapter(name, rank=rank, seed=seed)
        cards = {c.lora["adapter_id"]: c for c in adapter_cards(pipe.card, TP_ADAPTERS)}
    else:
        pipe = await build_pipeline(args, quant=quant, kv_quant=kv_quant)
    await asyncio.to_thread(pipe.engine.runner.warm_windows, ("greedy", "simple"))
    prompts = burst_prompts()

    async def one(i, adapter=None):
        p = pipe if adapter is None else LocalPipeline(cards[adapter], pipe.engine,
                                                       ByteTokenizer())
        req = CompletionRequest.parse({
            "model": p.card.name, "prompt": prompts[i], "max_tokens": BURST_TOKENS,
            "temperature": BURST_TEMPS[i], "seed": 1000 + i, "ignore_eos": True, "logprobs": 0})
        gen = None
        async for g, _chunk in p.run(req, Context()):
            gen = g
        return {"ids": list(gen.lp_tokens), "logprobs": list(gen.lp_values)}

    try:
        out = {"plain": list(await asyncio.gather(*(one(i) for i in range(len(prompts)))))}
        if lora:
            while pipe.engine.busy():
                await asyncio.sleep(0.001)
            pipe.engine.clear_kv_blocks()
            out["mixed"] = list(await asyncio.gather(*(one(i, TP_LORA_ROWS.get(i))
                                                       for i in range(len(prompts)))))
        return out
    finally:
        await pipe.engine.stop()


def tp_phase(card_line: str, reference, preset: str = "llama-8b", device: str = "cuda",
             dtype: str = "bfloat16", quant: str = "none", kv_quant: str = "none",
             model_path: str | None = None, tp: int = TP_RANKS, lora: bool = False) -> dict:
    """Phase 4t: ``python -m dynamo_tpu_torch.worker --tp 2`` (this worker is
    rank 0, the leader; it spawns rank 1, and both share the one card over
    gloo) behind the port's store; phase 4's burst sent through the
    worker's ``generate`` endpoint over the runtime. ``reference``:
    ``burst_reference``'s {"plain": each request's tp 1 token ids and
    logprobs}, or a function that makes it, run while the worker starts.
    Holds: every greedy stream equal to its reference
    except where the two passes' chosen tokens are within ``SPEC_GAP_TOL``
    nats (``tree_vs_dense_gaps``' rule), its logprobs up to there within
    ``TP_LP_TOL`` of the reference's, the follower's sampled-token digest
    equal to the leader's, attention launches = layers x substeps on each
    rank, the windows eager under gloo (its collectives cannot be
    captured) and all graph replays under NCCL (``tp`` ranks on as many
    cards of their own), every exit 0.

    With ``lora`` the worker has ``TP_LORA_SLOTS`` bank slots and the
    adapters ``TP_ADAPTERS`` (each rank its shard of the bank), and
    ``reference`` is ``burst_reference(..., lora=True)``'s: the burst runs
    as it is, then, after a cache clear that also sets every rank's launch
    counts to 0, with the rows of ``TP_LORA_ROWS`` under their adapters.
    Each burst is held against its tp 1 reference as above, and each
    rank's launches in each burst are layers x that burst's substeps, read
    on that rank (the follower prints its counts where they are set to
    0). The mixed burst's base rows equal the plain burst's token ids and
    logprobs bit for bit (the ``where`` contract: a bank changes no base
    row), each adapter row differs from its plain row (a dropped delta
    would leave it equal), and both ranks count the same LoRA-variant
    windows, more than none. → the phase's numbers, the plain burst's at
    the top level and the mixed one's under "lora"."""
    import numpy as np

    tag = ("tp" if quant == "none" else f"tp-int8-kv{kv_quant}") + ("" if tp == TP_RANKS
                                                                   else str(tp))
    cfg, weights = model_source(preset, model_path)
    L = cfg.num_layers
    store_port = _free_port()
    store_url = f"tcp://127.0.0.1:{store_port}"
    procs: list[Proc] = []
    try:
        store = Proc(f"{tag}-store", ["dynamo_tpu_torch.runtime.store_server", "--host",
                                      "127.0.0.1", "--port", str(store_port)])
        procs.append(store)
        store.wait_for(r"store server: tcp://", 60)
        worker = Proc(f"{tag}-worker", [
            "dynamo_tpu_torch.worker", "--store-url", store_url, "--tp", str(tp),
            *weights, "--dtype", dtype, "--device", device, "--quant", quant,
            "--kv-quant", kv_quant, "--disagg", "off", *(tp_lora_argv() if lora else ()),
            *ENGINE_ARGV])
        procs.append(worker)
        if callable(reference):
            reference = reference()
        m, _ = worker.wait_for(r"worker: (tp \d+ over \w+ \([^)]*\))", 120)
        backend = m.group(1)
        m, up_s = worker.wait_for(r"dynamo_tpu_torch worker: serving .*\((\d+) window graphs", 900)
        graphs = int(m.group(1))
        log(f"{tag}: {cfg.name} ({L} layers, {quant} weights, {kv_quant} KV pages) served by a "
            f"--tp {tp} worker, {backend}"
            + (f", {len(TP_ADAPTERS)} adapters over {TP_LORA_SLOTS} bank slots" if lora else "")
            + f", registered {up_s:.1f}s after launch ({card_line})")
        bursts, wall = {}, {}
        bursts["plain"], wall["plain"] = asyncio.run(_tp_burst(store_url, cfg.name))
        plain_c = settled_counters(worker)
        if lora:
            bursts["mixed"], wall["mixed"] = asyncio.run(_tp_burst(
                store_url, cfg.name, clear=True, adapters=TP_LORA_ROWS))
            mixed_c = settled_counters(worker)
        rc = worker.stop(120)
        if rc != 0:
            raise RuntimeError(f"{tag}: the leader exited rc={rc}: "
                               + " | ".join(worker.lines[-15:]))
    finally:
        for p in reversed(procs):
            p.kill()
    lead = next(json.loads(ln) for ln in reversed(worker.lines)
                if ln.startswith('{"event": "engine_counters"'))
    fols = sorted((json.loads(ln) for ln in worker.lines
                   if ln.startswith('{"event": "follower_counters"')), key=lambda c: c["rank"])
    zeroed = sorted((json.loads(ln) for ln in worker.lines
                     if ln.startswith('{"event": "follower_counts_zeroed"')),
                    key=lambda c: c["rank"])
    ranks = list(range(1, tp))
    if [c["rank"] for c in fols] != ranks or lora and [c["rank"] for c in zeroed] != ranks:
        raise RuntimeError(f"{tag}: follower counters of ranks {[c['rank'] for c in fols]}, "
                           f"counts set to 0 on ranks {[c['rank'] for c in zeroed]}")
    # Each burst's launches on each rank, counted from 0 on that rank: the
    # plain burst's from the warm-ups' end to the leader's reading after
    # it and to the follower's counts where the mixed burst's clear set
    # them to 0; the mixed burst's from that clear to every rank's end.
    plain_substeps = plain_c["decode_substeps"]
    runs = {"plain": (plain_substeps, [plain_c, *(zeroed if lora else fols)])}
    if lora:
        runs["mixed"] = (lead["decode_substeps"] - plain_substeps, [lead, *fols])
    cuda = device == "cuda"
    nccl = lead["tp"]["backend"] == "nccl"
    for name, (substeps, lines) in runs.items():
        want = L * substeps if cuda else 0
        for rank, c in enumerate(lines):
            if c["paged_attention_launches"] != want or substeps == 0:
                raise RuntimeError(f"{tag} {name}: rank {rank} attention launches "
                                   f"{c['paged_attention_launches']} != {L} layers x "
                                   f"{substeps} substeps")
    for who, c in (("leader", lead), *((f"follower {c['rank']}", c) for c in fols)):
        if cuda and (c["eager_windows"] == 0) != nccl:
            raise RuntimeError(f"{tag}: {who} ran {c['eager_windows']} windows eagerly under "
                               f"{lead['tp']['backend']}: gloo windows run eagerly, NCCL ones "
                               "replay their graphs")
    for c in fols:
        if lead["tp"]["token_digest"] != c["token_digest"]:
            raise RuntimeError(f"{tag}: follower {c['rank']}'s sampled-token digest "
                               f"{c['token_digest']} != the leader's {lead['tp']['token_digest']}")
        if lead["tp"]["calls"] != c["collectives"]["calls"]:
            raise RuntimeError(f"{tag}: collectives differ: leader {lead['tp']['calls']}, "
                               f"follower {c['rank']} {c['collectives']['calls']}")
    fol = fols[0]
    outs = bursts["plain"]
    for name, got_b in bursts.items():
        for i, o in enumerate(got_b):
            if len(o["ids"]) != BURST_TOKENS or not all(
                    np.isfinite(lp) and lp <= 0.0 for lp in o["logprobs"]):
                raise RuntimeError(f"{tag} {name} request {i}: bad token/logprob stream")
            if not all(0 <= t < cfg.vocab_size for t in o["ids"]):
                raise RuntimeError(f"{tag} {name} request {i}: token id out of range")
    greedy = [i for i, t in enumerate(BURST_TEMPS) if t == 0.0]
    held = {}
    for name, got_b in bursts.items():
        dense = [{"tokens": r["ids"], "logprobs": r["logprobs"]} for r in reference[name]]
        got = [{"tokens": o["ids"], "logprobs": o["logprobs"]} for o in got_b]
        gaps = tree_vs_dense_gaps(dense, got, greedy, f"{tag} {name}")
        # Logprob drift up to each greedy stream's first divergence (past it
        # the two continue different texts), by row.
        drift = {i: max(abs(a - b) for a, b in zip(
            got[i]["logprobs"][:_first_divergence(got[i]["tokens"], dense[i]["tokens"])],
            dense[i]["logprobs"])) for i in greedy}
        worst = max(drift, key=drift.get)
        if drift[worst] > TP_LP_TOL:
            raise RuntimeError(f"{tag} {name} request {worst}: |logprob - tp 1| "
                               f"{drift[worst]:.4g} before the streams part (> {TP_LP_TOL})")
        held[name] = {
            "greedy_equal": [i for i in greedy if got[i]["tokens"] == dense[i]["tokens"]],
            "gaps": gaps, "max_logprob_drift": drift[worst],
            "max_logprob_drift_adapter_rows": max(
                (d for i, d in drift.items() if name == "mixed" and i in TP_LORA_ROWS),
                default=None),
            "sampled_equal": [i for i in range(len(got)) if i not in greedy
                              and got[i]["tokens"] == dense[i]["tokens"]]}
    equal, gaps = held["plain"]["greedy_equal"], held["plain"]["gaps"]
    drift, sampled_equal = held["plain"]["max_logprob_drift"], held["plain"]["sampled_equal"]
    tokens = sum(len(o["ids"]) for o in outs)
    calls = lead["tp"]["calls"]
    # Each prefill chunk (a prompt's chunk plan, padded to its rung) makes
    # 2L + 1 all-reduces of its rows' hidden states and one all-gather of
    # one row's logit slice; each decode substep as many, over the batch's
    # 8 rows. An adapter's deltas add none: the o delta rides wo's sum.
    per_forward = 2 * L + 2
    bs = int(ENGINE_ARGV[ENGINE_ARGV.index("--block-size") + 1])
    chunks = prefill_chunk_buckets(BURST_LENS, bs) * len(bursts)
    prefill_calls = len(chunks) * per_forward
    elt = 2 if dtype == "bfloat16" else 4
    rows = int(ENGINE_ARGV[ENGINE_ARGV.index("--max-num-seqs") + 1])
    vocab_slice = cfg.vocab_size // tp * 4
    prefill_bytes = sum(T * cfg.hidden_size * elt * (2 * L + 1) + vocab_slice for T in chunks)
    want_bytes = rows * (cfg.hidden_size * elt * (2 * L + 1) + vocab_slice)
    # The groups count the collectives Python calls: every one under gloo,
    # where windows run eagerly; under NCCL a captured window's collectives
    # replay inside its graph, uncounted, so no per-substep figure comes
    # from the counts there.
    all_substeps = lead["decode_substeps"]
    per_substep = (None, None) if nccl else (
        (sum(calls.values()) - prefill_calls) / all_substeps,
        (lead["tp"]["bytes"] - prefill_bytes) / all_substeps)
    decode_s = sum(plain_c["phase_s"].get(k, 0.0) for k in DECODE_PHASES)

    def int8_launches(lines):
        return [[c[k] for k in ("int8_matmul_launches", "int8_matmul_wide_launches",
                                "int8_matmul_prefill_launches")] for c in lines]

    st = {"backend": backend, "tokens_per_s": tokens / wall["plain"], "wall_s": wall["plain"],
          "substeps": plain_substeps, "ms_per_substep": decode_s / plain_substeps * 1e3,
          "launches": [c["paged_attention_launches"] for c in runs["plain"][1]],
          "int8_launches": int8_launches(runs["plain"][1]),
          "graphs_captured": graphs,
          "collectives": calls, "collective_bytes": lead["tp"]["bytes"],
          "collectives_per_substep": per_substep[0],
          "expected_per_substep": per_forward, "bytes_per_substep": per_substep[1],
          "expected_bytes_per_substep": want_bytes,
          "collective_host_s": [lead["tp"]["host_s"], *(c["collectives"]["host_s"] for c in fols)],
          "peak_gib": [c["peak_device_bytes"] / 2**30 for c in (lead, *fols)],
          "eager_windows": [c["eager_windows"] for c in (lead, *fols)],
          "token_digest": fol["token_digest"], "frames": lead["tp"]["frames"],
          "frame_bytes": lead["tp"]["frame_bytes"], "greedy_equal": equal, "gaps": gaps,
          "max_logprob_drift": drift, "sampled_equal": sampled_equal, "registered_s": up_s}
    log(f"{tag}: {len(outs)} requests, {tokens} tokens in {wall['plain']:.3f}s → "
        f"{st['tokens_per_s']:.1f} tokens/s; {plain_substeps} substeps, "
        f"{st['ms_per_substep']:.3f} host ms per substep; attention launches by rank "
        f"{st['launches']} = {L} x {plain_substeps}; eager windows {st['eager_windows']}, "
        f"{st['graphs_captured']} window graphs captured ({card_line})")
    for name, h in held.items():
        log(f"{tag} {name}: greedy rows {h['greedy_equal']} equal to tp 1's stream token for "
            f"token; {len(h['gaps'])} leave it where the two chosen tokens are "
            f"{[round(g, 4) for g in h['gaps']]} nats apart (|gap| < {SPEC_GAP_TOL}); max "
            f"|logprob - tp 1| on equal tokens {h['max_logprob_drift']:.4g} (bound "
            f"{TP_LP_TOL}); sampled rows equal: {h['sampled_equal']}")
    log(f"{tag}: follower digest {fol['token_digest']} == leader's")
    if lora:
        mixed = bursts["mixed"]
        base = [i for i in range(len(outs)) if i not in TP_LORA_ROWS]
        differs = [i for i in base if mixed[i] != outs[i]]
        if differs:
            raise RuntimeError(f"{tag}: base rows {differs} of the mixed burst differ from the "
                               "plain burst's (token ids or logprobs)")
        same = [i for i in sorted(TP_LORA_ROWS) if mixed[i] == outs[i]]
        if same:
            raise RuntimeError(f"{tag}: adapter rows {same} of the mixed burst equal the plain "
                               "burst's: their adapter's delta was not applied")
        # Where each adapter row's stream leaves its plain row's (token
        # ids), at tp 2 and in the tp 1 reference: what the adapters change.
        parts = {who: {i: _first_divergence(b["mixed"][i]["ids"], b["plain"][i]["ids"])
                       for i in sorted(TP_LORA_ROWS)}
                 for who, b in (("tp", bursts), ("tp1", reference))}
        lora_windows = [lead["lora"]["windows"], *(c["lora_windows"] for c in fols)]
        if len(set(lora_windows)) != 1 or lora_windows[0] == 0:
            raise RuntimeError(f"{tag}: LoRA-variant windows by rank {lora_windows}")
        if lead["lora"]["uploads"] < len(TP_ADAPTERS):
            raise RuntimeError(f"{tag}: {lead['lora']['uploads']} adapter uploads")
        mixed_substeps, mixed_lines = runs["mixed"]
        mixed_decode_s = sum(mixed_c["phase_s"].get(k, 0.0) for k in DECODE_PHASES) - decode_s
        st["lora"] = {
            **held["mixed"], "tokens_per_s": sum(len(o["ids"]) for o in mixed) / wall["mixed"],
            "wall_s": wall["mixed"], "substeps": mixed_substeps,
            "ms_per_substep": mixed_decode_s / mixed_substeps * 1e3,
            "launches": [c["paged_attention_launches"] for c in mixed_lines],
            "int8_launches": int8_launches(mixed_lines),
            "lora_windows": lora_windows, "uploads": lead["lora"]["uploads"],
            "base_rows_equal_plain": base, "adapter_rows_differ": sorted(TP_LORA_ROWS),
            "adapter_rows_part_at": parts["tp"], "adapter_rows_part_at_tp1": parts["tp1"]}
        log(f"{tag} mixed: rows {sorted(TP_LORA_ROWS)} under {len(TP_ADAPTERS)} adapters: "
            f"{st['lora']['tokens_per_s']:.1f} tokens/s, {mixed_substeps} substeps, "
            f"{st['lora']['ms_per_substep']:.3f} host ms per substep; base rows {base} equal "
            f"the plain burst's bit for bit; each adapter row leaves its plain row at token "
            f"{parts['tp']} (tp 1: {parts['tp1']}); max |logprob - tp 1| on adapter rows "
            f"{held['mixed']['max_logprob_drift_adapter_rows']:.4g}; LoRA-variant windows by "
            f"rank {lora_windows}; attention launches by rank {st['lora']['launches']} = {L} x "
            f"{mixed_substeps}, counted from 0 on each rank ({card_line})")
    mib = lead["tp"]["bytes"] / 2**20
    counted = (f"{per_substep[0]:.1f} per substep past the prefills, {per_forward} a forward; "
               f"{mib:.1f} MiB in them, {per_substep[1] / 2**20:.3f} MiB per substep past the "
               f"prefills" if not nccl else
               f"the calls from Python; a captured window's {per_forward} a substep replay "
               f"uncounted; {mib:.1f} MiB in those calls")
    log(f"{tag}: {backend}: tokens/s {st['tokens_per_s']:.1f}, ms per substep "
        f"{st['ms_per_substep']:.3f}, collectives {calls} ({counted}; "
        f"{want_bytes / 2**20:.3f} MiB a forward of {rows} rows), host ms in collectives "
        f"{' / '.join(f'{1e3 * h:.1f}' for h in st['collective_host_s'])}, peak memory per rank "
        f"{' / '.join(f'{g:.2f}' for g in st['peak_gib'])} GiB, {st['frames']} frames of "
        f"{st['frame_bytes'] / 2**10:.1f} KiB to the follower ({card_line})")
    return st


def tp_nccl_main(card_line: str) -> int:
    """``python3 chip_smoke.py --tp-nccl`` on a host of two or more cards:
    phase 4t's bf16 leg with each rank on a card of its own, so the ranks
    meet over NCCL and every window is a CUDA graph with its collectives
    inside; at tp 2, and at tp 4 on four cards; with the int8 leg's
    adapters, so the LoRA variants' graphs run too. Held as phase 4t holds
    the one-card run, against the burst in process at tp 1 on card 0. Then
    phase 4p over NCCL, its ranks on cards of their own: at 2 ranks, and at
    4 on four cards. Prints the results and the card line before the last
    line, as the one-card run does."""
    import torch

    n = torch.cuda.device_count()
    if n < 2:
        print(f"chip_smoke --tp-nccl: {n} card(s) visible; the NCCL path needs two",
              file=sys.stderr)
        return 2
    ref = asyncio.run(burst_reference(["--preset", "llama-8b"], lora=True))
    out = {tp: tp_phase(card_line, ref, tp=tp, lora=True) for tp in (2, 4) if tp <= n}
    log("tp_nccl_path: " + json.dumps(out))
    par = {r: parallel_phase(card_line, n=r) for r in (2, 4) if r <= n}
    log("parallel_nccl_path: " + json.dumps(par))
    print(json.dumps({"tp_nccl": {tp: {k: st[k] for k in (
        "backend", "tokens_per_s", "ms_per_substep", "substeps", "launches", "graphs_captured",
        "eager_windows", "greedy_equal", "gaps", "peak_gib", "lora")}
        for tp, st in out.items()}, "parallel_nccl": par}), flush=True)
    print(card_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": n}}), flush=True)
    return 0


async def _tp_burst(store_url: str, model: str, clear: bool = False,
                    adapters: dict | None = None):
    """Phase 4's burst through the worker's generate endpoint → (each
    request's token ids and logprobs, wall seconds). ``clear`` first empties
    the worker's prefix cache and sets its launch counts to 0 on every rank
    (its ``clear_kv`` endpoint); ``adapters`` names the adapter of each row
    that has one."""
    from dynamo_tpu_torch.llm.protocols import PreprocessedRequest
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.engine import Context
    from dynamo_tpu_torch.runtime.push_router import RouterMode

    rt = await DistributedRuntime.create(store_url=store_url)
    try:
        comp = rt.namespace("dynamo").component("backend")
        router = await comp.endpoint("generate").router(RouterMode.ROUND_ROBIN)
        await router.discovery.wait_for_instances(1)
        if clear:
            clearer = await comp.endpoint("clear_kv").router(RouterMode.ROUND_ROBIN)
            await clearer.discovery.wait_for_instances(1)
            async for _ in clearer.generate({"zero_counts": True}, Context()):
                pass

        async def one(i, prompt):
            req = PreprocessedRequest(model=model, token_ids=list(prompt.encode()),
                                      eos_token_ids=[257])
            req.adapter_id = (adapters or {}).get(i)
            req.sampling.temperature = BURST_TEMPS[i]
            req.sampling.seed = 1000 + i
            req.sampling.logprobs = True
            req.stop.max_tokens = BURST_TOKENS
            req.stop.ignore_eos = True
            ids, lps = [], []
            async for item in router.generate(req.to_dict(), Context()):
                ids += item.get("token_ids") or []
                lps += item.get("log_probs") or []
            return {"ids": ids, "logprobs": lps}

        t0 = time.perf_counter()
        outs = await asyncio.gather(*(one(i, p) for i, p in enumerate(burst_prompts())))
        return list(outs), time.perf_counter() - t0
    finally:
        await rt.shutdown()


# -- phase 4p: the pipeline, ring-attention and expert-parallel ops --------------

PAR_RANKS = 2
PAR_SEED = 22
# The checks' sizes: on the card llama-8b's attention and MLP widths and
# moe-wide whole; on the CPU (the rehearsal) test-tiny's and moe-tiny.
PAR_CARD = {"ring": {"T": 8192, "H": 32, "KVH": 8, "hd": 128, "dtype": "bfloat16"},
            "pipeline": {"L": 32, "D": 4096, "I": 14336, "B": 16, "M": 4,
                         "dtype": "bfloat16"},
            "ep": {"preset": "moe-wide", "B": 8, "steps": 4, "blocks": 64, "bs": 16}}
PAR_CPU = {"ring": {"T": 64, "H": 4, "KVH": 2, "hd": 16, "dtype": "float32"},
           "pipeline": {"L": 4, "D": 32, "I": 64, "B": 16, "M": 4, "dtype": "float32"},
           "ep": {"preset": "moe-tiny", "B": 4, "steps": 3, "blocks": 32, "bs": 8}}
# |ring − f32 dense| ≤ atol + rtol·|dense|, by mode. bf16: the ring's scores
# and probabilities are bf16 into exp and PV, and its output is bf16; the
# causal errors are largest on the early rows, whose few keys average no
# rounding away and whose outputs are large. At T 8,192 on the card the
# sound ring's largest errors (0.01315 causal, 0.0023 non-causal) took
# 0.67 and 0.37 of these bounds, the controls (the ring over an exchange
# that never delivers) 17 and 26 times them (PERF.md §6). A float32 ring
# is held at tests' 2e-5.
PAR_RING_TOL = {"bfloat16": {"causal": (1e-2, 2e-2), "non_causal": (4e-3, 2e-2)},
                "float32": {"causal": (2e-5, 2e-5), "non_causal": (2e-5, 2e-5)}}
# |pipeline − sequential| ≤ this share of the sequential output's largest
# magnitude. On the card the pipeline matched the scan bit for bit in every
# run (a microbatch's rows take the whole batch's bf16 products); half a
# bf16 step at the largest output leaves room for a product that rounds
# once otherwise, and the control's error is of the outputs' own size.
PAR_PIPE_TOL = {"bfloat16": 2.0 ** -8, "float32": 2e-5}
# |ep step − unsharded step| ≤ atol + rtol·|unsharded| on float32 logits: the
# experts' combine is summed in two (or n) parts, then across the ranks, so
# the sums round in another order (tests/test_moe.py's 2e-4).
PAR_EP_TOL = (2e-4, 2e-4)


def swiglu_block(x, lp):
    """tests/test_pipeline.py's layer: residual RMSNorm + SwiGLU."""
    import torch

    xf = x.float()
    h = (xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-5)).to(x.dtype)
    g, u = h @ lp["w_gate"], h @ lp["w_up"]
    return x + (torch.nn.functional.silu(g.float()).to(x.dtype) * u) @ lp["w_down"]


def _par_timed(dev, fn):
    """fn() once to warm, once timed → (its result, ms)."""
    import torch

    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, (time.perf_counter() - t0) * 1e3


def _par_delta(group, before: tuple) -> dict:
    calls, nbytes = before
    return {"calls": {k: v - calls[k] for k, v in group.calls.items()},
            "bytes": group.bytes - nbytes}


class _LostExchange:
    """A ``TpGroup`` whose neighbour exchange hands each rank its own
    tensors back, as if the neighbour's never arrived; its other
    collectives are the group's. Phase 4p's control: a ring or a pipeline
    run over it is wrong, and its error must leave the check's bound."""

    def __init__(self, group):
        self._group = group

    def __getattr__(self, name):
        return getattr(self._group, name)

    def ppermute_start(self, xs):
        return _Kept(list(xs))


class _Kept:
    def __init__(self, xs):
        self.xs = xs

    def wait(self):
        return self.xs


def _par_ring(group, dev, z: dict) -> dict:
    """``ring_prefill`` at ``z``'s widths, causal and not: the timed call's
    ms and collectives; on rank 0 its max error against a dense f32
    attention computed 512 query rows at a time, and the error of the
    control (the call over ``_LostExchange``), each also as the largest
    share of the bound ``PAR_RING_TOL`` it takes."""
    import torch

    from dynamo_tpu_torch.ops.ring_attention import ring_prefill

    T, H, KVH, hd = z["T"], z["H"], z["KVH"], z["hd"]
    G = H // KVH
    dt = getattr(torch, z["dtype"])
    g = torch.Generator(device=dev).manual_seed(PAR_SEED)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(dt)
               for shape in ((T, H, hd), (T, KVH, hd), (T, KVH, hd)))
    out = {}
    for causal in (True, False):
        mode = "causal" if causal else "non_causal"
        atol, rtol = PAR_RING_TOL[z["dtype"]][mode]
        before = (dict(group.calls), group.bytes)
        o, ms = _par_timed(dev, lambda: ring_prefill(group, q, k, v, causal=causal))
        moved = _par_delta(group, before)
        r = {"ms": ms, "exchanges": moved["calls"]["ppermute"] // 2,
             "bytes": moved["bytes"] // 2, "gathers": moved["calls"]["all_gather"] // 2,
             "finite": bool(torch.isfinite(o).all()), "shape": list(o.shape)}
        control = ring_prefill(_LostExchange(group), q, k, v, causal=causal)
        if group.rank == 0:
            kf, vf = k.float(), v.float()
            err = {"": [0.0, 0.0], "control_": [0.0, 0.0]}  # max |err|, its share of the bound
            for lo in range(0, T, 512):
                qg = q[lo:lo + 512].float().reshape(-1, KVH, G, hd)
                s = torch.einsum("tkgh,skh->tkgs", qg, kf) * hd ** -0.5
                if causal:
                    pos = torch.arange(lo, lo + qg.shape[0], device=dev)
                    keep = torch.arange(T, device=dev)[None, :] <= pos[:, None]
                    s = s.masked_fill(~keep[:, None, None, :], float("-inf"))
                ref = torch.einsum("tkgs,skh->tkgh", s.softmax(-1), vf).reshape(-1, H, hd)
                for key, got in (("", o), ("control_", control)):
                    d = (got[lo:lo + 512].float() - ref).abs()
                    e = err[key]
                    e[0] = max(e[0], float(d.max()))
                    e[1] = max(e[1], float((d / (atol + rtol * ref.abs())).max()))
                del s, ref, d
            for key, (e, share) in err.items():
                r.update({f"{key}max_abs_err": e, f"{key}tol_ratio": share})
        out[mode] = r
        del o, control
    return out


def _par_pipeline(group, dev, z: dict) -> dict:
    """``pipeline_apply`` of ``swiglu_block`` at ``z``'s widths (every rank
    holds all the layers, each runs its stage): the timed call's ms and
    collectives; on rank 0 its max error against the sequential scan of
    the whole batch, and the control's (the call over ``_LostExchange``)."""
    import torch

    from dynamo_tpu_torch.ops.pipeline import pipeline_apply

    L, D, I, B, M = z["L"], z["D"], z["I"], z["B"], z["M"]
    dt = getattr(torch, z["dtype"])
    g = torch.Generator(device=dev).manual_seed(PAR_SEED + 1)
    params = {"w_gate": torch.empty((L, D, I), dtype=dt, device=dev),
              "w_up": torch.empty((L, D, I), dtype=dt, device=dev),
              "w_down": torch.empty((L, I, D), dtype=dt, device=dev)}
    for layer in range(L):  # drawn in f32 a layer at a time, then cast
        for name, w in params.items():
            w[layer] = torch.randn(w.shape[1:], generator=g, device=dev) * w.shape[1] ** -0.5
    x = torch.randn((B, D), generator=g, device=dev).to(dt)
    before = (dict(group.calls), group.bytes)
    y, ms = _par_timed(dev, lambda: pipeline_apply(group, params, x, swiglu_block, M))
    moved = _par_delta(group, before)
    r = {"ms": ms, "exchanges": moved["calls"]["ppermute"] // 2, "bytes": moved["bytes"] // 2,
         "sums": moved["calls"]["all_reduce"] // 2, "finite": bool(torch.isfinite(y).all()),
         "shape": list(y.shape)}
    if group.rank == 0:
        def sequential():
            s = x
            for layer in range(L):
                s = swiglu_block(s, {n: w[layer] for n, w in params.items()})
            return s

        ref, r["sequential_ms"] = _par_timed(dev, sequential)
        r["max_abs_err"] = float((y.float() - ref.float()).abs().max())
        r["ref_max_abs"] = float(ref.float().abs().max())
    control = pipeline_apply(_LostExchange(group), params, x, swiglu_block, M)
    if group.rank == 0:
        r["control_max_abs_err"] = float((control.float() - ref.float()).abs().max())
    del params
    return r


def _par_ep(group, dev, z: dict) -> dict:
    """``z["steps"]`` float32 decode steps of ``z["preset"]`` with its
    experts split over the ranks (ep = ranks, tp = 1), from an empty cache,
    each step's tokens the greedy ones of the one before: per-step ms and
    collectives, the attention launches of those steps; on rank 0 each
    step's max logit error against the unsharded step on the same tokens."""
    import numpy as np
    import torch

    from dynamo_tpu_torch.engine import model as M
    from dynamo_tpu_torch.engine.config import ModelConfig
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.parallel.mesh import ModelSharding

    cfg = ModelConfig.preset(z["preset"])
    n = group.size
    sh = ModelSharding(cfg, 1, group.rank, group, ep=n)
    B, N, bs, steps = z["B"], z["blocks"], z["bs"], z["steps"]
    rng = np.random.default_rng(PAR_SEED)
    W = N // B
    tables = torch.from_numpy(rng.permutation(np.arange(1, N))[:B * (W - 1)]
                              .reshape(B, W - 1).astype(np.int32)).to(dev)
    tokens0 = torch.from_numpy(rng.integers(1, cfg.vocab_size, B).astype(np.int32)).to(dev)
    pos0 = torch.from_numpy(rng.integers(0, (W - 1) * bs - steps, B).astype(np.int32)).to(dev)
    active = torch.ones((B,), dtype=torch.bool, device=dev)

    def run(params, shard):
        cache = M.init_kv_cache(cfg if shard is None else shard.local, N, bs, torch.float32,
                                dev)
        toks, pos, logits, ms = tokens0, pos0, [], []
        for i in range(steps):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            lg = M.decode_step(cfg, params, cache, toks, pos, tables, active, tp=shard)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            logits.append(lg)
            toks = feed[i] if shard is None else lg.argmax(-1).to(torch.int32)
            if shard is not None:
                feed.append(toks)
            pos = pos + 1
        return logits, ms

    feed: list = []
    params = M.init_params(cfg, dev, torch.float32, PAR_SEED, shard=sh)
    zero_counts()
    before = (dict(group.calls), group.bytes)
    got, ms = run(params, sh)
    r = {"ms_per_step": ms, "launches": pa.launches, "layers": cfg.num_layers,
         "steps": steps, "experts": list(sh.experts), **_par_delta(group, before),
         "finite": all(bool(torch.isfinite(lg).all()) for lg in got)}
    del params
    if group.rank == 0:
        full = M.init_params(cfg, dev, torch.float32, PAR_SEED)
        want, r["unsharded_ms_per_step"] = run(full, None)
        atol, rtol = PAR_EP_TOL
        r["max_abs_err"] = max(float((a - b).abs().max()) for a, b in zip(got, want))
        r["tol_ratio"] = max(float(((a - b).abs() / (atol + rtol * b.abs())).max())
                             for a, b in zip(got, want))
        del full
    return r


def _par_rank_main(rank: int, n: int, coord: str, device: str, sizes: dict, q) -> None:
    """One rank of phase 4p: its group (ep = n blocks of one tp rank, the
    ring over all n), then the ring, pipeline and ep checks → the queue."""
    import traceback

    import torch

    from dynamo_tpu_torch.parallel.comm import TpGroup, rank_device

    try:
        if device == "cpu":
            torch.set_num_threads(1)
        dev = rank_device(device, rank)
        group = TpGroup(rank, n, coord, dev, ep=n)
        try:
            out = {"describe": group.describe()}
            for name, check in (("ring", _par_ring), ("pipeline", _par_pipeline),
                                ("ep", _par_ep)):
                out[name] = check(group, dev, sizes[name])
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
            out["peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2**30
                               if dev.type == "cuda" else 0.0)
            q.put((rank, "ok", out))
        finally:
            group.close()
    except BaseException:  # noqa: BLE001 — reported to the parent, which raises
        q.put((rank, "error", traceback.format_exc()))


def parallel_phase(card_line: str, device: str = "cuda", sizes: dict = PAR_CARD,
                   n: int = PAR_RANKS, timeout: float = 600.0) -> dict:
    """Phase 4p: ``n`` rank processes (spawned once; on one card they share
    it and meet over gloo, on n cards of their own over NCCL) run three
    checks of the ops the engines do not call: ``ring_prefill`` (sp = n)
    against a dense f32 attention, ``pipeline_apply`` (pp = n) against the
    sequential scan, and decode steps with the experts over ep = n against
    the unsharded step, each within its stated tolerance, on rank 0. Every
    rank's outputs finite and of their shape, the exchanges and bytes as
    the schedules make them, and on the card the attention kernel
    launched ``layers`` times a step on every ep rank. → the phase's
    numbers, rank by rank."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    coord = f"127.0.0.1:{_free_port()}"
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_par_rank_main, args=(r, n, coord, device, sizes, q))
             for r in range(n)]
    for p in procs:
        p.start()
    ranks: dict[int, dict] = {}
    try:
        for _ in range(n):
            rank, status, val = q.get(timeout=timeout)
            if status != "ok":
                raise RuntimeError(f"4p: rank {rank} failed:\n{val}")
            ranks[rank] = val
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    wall = time.perf_counter() - t0
    res = [ranks[r] for r in range(n)]
    lead = res[0]
    cuda = device == "cuda"
    zr, zp, ze = sizes["ring"], sizes["pipeline"], sizes["ep"]
    # ring: n − 1 exchanges of a (k, v) chunk a call, one gather of the output
    elt = 2 if zr["dtype"] == "bfloat16" else 4
    Tc = zr["T"] // n
    ring_bytes = (n - 1) * 2 * Tc * zr["KVH"] * zr["hd"] * elt + Tc * zr["H"] * zr["hd"] * elt
    # pipeline: M + n − 1 exchanges of a microbatch, one sum of the outputs
    pe = 2 if zp["dtype"] == "bfloat16" else 4
    steps_p = zp["M"] + n - 1
    pipe_bytes = steps_p * zp["B"] // zp["M"] * zp["D"] * pe + zp["B"] * zp["D"] * pe
    for rank, r in enumerate(res):
        for mode in ("causal", "non_causal"):
            m = r["ring"][mode]
            if (not m["finite"] or m["shape"] != [zr["T"], zr["H"], zr["hd"]]
                    or (m["exchanges"], m["gathers"], m["bytes"]) != (n - 1, 1, ring_bytes)):
                raise RuntimeError(f"4p ring {mode} rank {rank}: {m} (want {n - 1} exchanges, "
                                   f"1 gather, {ring_bytes} bytes)")
        m = r["pipeline"]
        if (not m["finite"] or m["shape"] != [zp["B"], zp["D"]]
                or (m["exchanges"], m["sums"], m["bytes"]) != (steps_p, 1, pipe_bytes)):
            raise RuntimeError(f"4p pipeline rank {rank}: {m} (want {steps_p} exchanges, 1 "
                               f"sum, {pipe_bytes} bytes)")
        m = r["ep"]
        want = m["layers"] * m["steps"] if cuda else 0
        if not m["finite"] or m["launches"] != want:
            raise RuntimeError(f"4p ep rank {rank}: finite {m['finite']}, attention launches "
                               f"{m['launches']} != {want}")
        if m["calls"]["all_reduce"] != m["layers"] * m["steps"] or m["calls"]["all_gather"]:
            raise RuntimeError(f"4p ep rank {rank}: collectives {m['calls']}: want one sum of "
                               "the experts' combine a layer, nothing over the tp block of one")
    for mode in ("causal", "non_causal"):
        m, tol = lead["ring"][mode], PAR_RING_TOL[zr["dtype"]][mode]
        if m["tol_ratio"] > 1.0:
            raise RuntimeError(f"4p ring {mode}: max error {m['max_abs_err']} outside {tol} of "
                               "the dense attention")
        if m["control_tol_ratio"] <= 1.0:
            raise RuntimeError(f"4p ring {mode}: the control (each rank's own kv chunk in place "
                               f"of its neighbour's) stays within {tol} (max error "
                               f"{m['control_max_abs_err']}): the bound does not tell a lost "
                               "exchange")
    pipe = lead["pipeline"]
    pipe_bound = PAR_PIPE_TOL[zp["dtype"]] * pipe["ref_max_abs"]
    if pipe["max_abs_err"] > pipe_bound:
        raise RuntimeError(f"4p pipeline: max error {pipe['max_abs_err']} against the "
                           f"sequential scan (largest |output| {pipe['ref_max_abs']})")
    if pipe["control_max_abs_err"] <= pipe_bound:
        raise RuntimeError(f"4p pipeline: the control (each stage's own output in place of "
                           f"the one before's) stays within {pipe_bound} (max error "
                           f"{pipe['control_max_abs_err']}): the bound does not tell a lost "
                           "exchange")
    if lead["ep"]["tol_ratio"] > 1.0:
        raise RuntimeError(f"4p ep: max logit error {lead['ep']['max_abs_err']} outside "
                           f"{PAR_EP_TOL} of the unsharded step")
    st = {"backend": lead["describe"], "wall_s": wall, "ranks": n,
          "ring": {mode: {**{k: lead["ring"][mode][k] for k in (
                              "max_abs_err", "tol_ratio", "control_max_abs_err",
                              "control_tol_ratio")},
                          "ms": [r["ring"][mode]["ms"] for r in res],
                          "exchanges": n - 1, "bytes": ring_bytes}
                   for mode in ("causal", "non_causal")},
          "pipeline": {"max_abs_err": pipe["max_abs_err"], "ref_max_abs": pipe["ref_max_abs"],
                       "control_max_abs_err": pipe["control_max_abs_err"],
                       "ms": [r["pipeline"]["ms"] for r in res],
                       "sequential_ms": pipe["sequential_ms"], "exchanges": steps_p,
                       "bytes": pipe_bytes},
          "ep": {"max_abs_err": lead["ep"]["max_abs_err"],
                 "ms_per_step": [r["ep"]["ms_per_step"] for r in res],
                 "unsharded_ms_per_step": lead["ep"]["unsharded_ms_per_step"],
                 "launches": [r["ep"]["launches"] for r in res],
                 "collectives": lead["ep"]["calls"], "bytes": lead["ep"]["bytes"],
                 "experts": [r["ep"]["experts"] for r in res]},
          "peak_gib": [r["peak_gib"] for r in res]}
    rt = st["ring"]
    log(f"4p: {n} rank processes, {st['backend']}, three checks in {wall:.1f}s; peak memory "
        f"per rank {' / '.join(f'{g:.2f}' for g in st['peak_gib'])} GiB ({card_line})")
    for mode in ("causal", "non_causal"):
        m = rt[mode]
        log(f"4p ring_prefill {mode}: T {zr['T']}, H {zr['H']}, KVH {zr['KVH']}, hd "
            f"{zr['hd']}, {zr['dtype']}, sp {n}: max |err| {m['max_abs_err']:.4g} against a "
            f"dense f32 attention, {m['tol_ratio']:.3g} of the bound "
            f"{PAR_RING_TOL[zr['dtype']][mode]} (atol, rtol); control over a lost exchange "
            f"{m['control_max_abs_err']:.4g}, {m['control_tol_ratio']:.3g} of it; ms by rank "
            f"{' / '.join(f'{x:.2f}' for x in rt[mode]['ms'])}, {n - 1} exchanges of a (k, v) "
            f"chunk and 1 gather, {ring_bytes} bytes a rank ({card_line})")
    log(f"4p pipeline_apply: {zp['L']} layers of D {zp['D']}, I {zp['I']}, {zp['dtype']}, pp "
        f"{n}, B {zp['B']}, M {zp['M']}: max |err| {pipe['max_abs_err']:.4g} against the "
        f"sequential scan (largest |output| {pipe['ref_max_abs']:.4g}, bound "
        f"{PAR_PIPE_TOL[zp['dtype']]:.4g} of it); control over a lost exchange "
        f"{pipe['control_max_abs_err']:.4g}; ms by rank "
        f"{' / '.join(f'{x:.2f}' for x in st['pipeline']['ms'])} (sequential "
        f"{pipe['sequential_ms']:.2f}), {steps_p} exchanges and 1 sum, {pipe_bytes} bytes a rank "
        f"({card_line})")
    e = st["ep"]
    log(f"4p ep: {ze['preset']} float32, ep {n}, {ze['steps']} decode steps of {ze['B']} rows: "
        f"max |logit err| {e['max_abs_err']:.4g} against the unsharded step (tolerance "
        f"{PAR_EP_TOL}), ms per step by rank "
        f"{' / '.join(','.join(f'{x:.2f}' for x in ms) for ms in e['ms_per_step'])} (unsharded "
        f"{','.join(f'{x:.2f}' for x in e['unsharded_ms_per_step'])}), attention launches by "
        f"rank {e['launches']}, experts by rank {e['experts']}, collectives {e['collectives']} "
        f"({e['bytes']} bytes) ({card_line})")
    return st


async def busy_pass(engine, one, prompts, temps, first, card_line):
    """One greedy prompt alone again, under torch.profiler, whose CUDA kernel
    records split the pass's wall time into device-busy time and the rest.
    → the busy share (None when the profiler saw no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    engine.clear_kv_blocks()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        again = await one(0, prompts[0], temps[0], 1000)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
    if again["tokens"] != first[0]["tokens"]:
        raise RuntimeError("second greedy pass of request 0 differs from its first pass")
    log("main: second greedy pass of request 0 alone is token-identical to its first pass")
    kernels = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
         if "CUDA" in str(e.device_type) and e.self_device_time_total > 0),
        key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels)
    if busy_ms == 0:
        log("profile: the profiler recorded no device time (device busy share not measured)")
        return None
    busy_share = busy_ms / (wall2 * 1e3)
    attn_ms = sum(k[1] for k in kernels if "paged_attention" in k[0])
    log(f"profile: second pass (1 request, 64 tokens, profiler on): wall {wall2 * 1e3:.1f} ms, "
        f"device busy {busy_ms:.1f} ms ({100 * busy_share:.1f}%), "
        f"paged_attention {attn_ms:.1f} ms ({card_line})")
    for name, ms, n in kernels[:6]:
        log(f"profile:   {ms:9.3f} ms  {n:6d}x  {name[:90]}")
    return busy_share


def window_inputs(runner, mode, seed, K=8, lens=None, live=6):
    """Prefill ``live`` rows of random prompts (of lengths ``lens``, else
    random 5..39) on ``runner`` (disjoint blocks, room for two K-step windows),
    sample their first tokens in
    ``mode`` with the fold into ``last_toks``, and return the operands of
    the next K-step window over them, chained from the folds and padded to
    the batch bucket. The rows mix greedy and sampled temperatures; in
    "full" mode they also carry top-k, top-p and both penalties."""
    import numpy as np

    args, V = runner.args, runner.cfg.vocab_size
    bs, B, sink = args.block_size, args.bucket_decode(live), args.max_num_seqs
    rng = np.random.default_rng(seed)
    lens = rng.integers(5, 40, live) if lens is None else np.resize(np.asarray(lens), live)
    tables, logits, nxt = [], [], 1
    for n in lens:
        nblk = -(-(int(n) + 2 * K + 1) // bs)
        tables.append(list(range(nxt, nxt + nblk)))
        nxt += nblk
        toks = np.zeros((-(-int(n) // bs) * bs,), np.int32)
        toks[:n] = rng.integers(1, V, n)
        # Set-up, op by op: these ad-hoc shapes are not the engine's ladder.
        logits.append(runner.prefill_chunk(toks, np.asarray(tables[-1], np.int32), 0, int(n),
                                           eager=True))
    W = args.bucket_table(max(len(t) for t in tables))
    tab = np.zeros((B, W), np.int32)
    for i, t in enumerate(tables):
        tab[i, : len(t)] = t
    def f(v, dt=np.float32):  # six rows' values, repeated over the live rows, then padding
        return np.asarray((v * -(-live // len(v)))[:live] + [0] * (B - live), dt)

    temps = f([0.0, 0.8, 0.0, 1.1, 0.6, 0.9])
    if mode == "greedy":
        temps[:] = 0.0
    full = mode == "full"
    tks = f([0, 5, 40, 0, 3, 0] if full else [0] * live, np.int32)
    tps = f([1.0, 0.9, 1.0, 0.8, 1.0, 0.95] if full else [1.0] * live)
    freqs = f([0.0, 0.5, 0.25, 0.0, 1.0, 0.5] if full else [0.0] * live)
    press = f([0.0, 0.25, 0.0, 0.5, 0.0, 1.0] if full else [0.0] * live)
    seeds = f(list(range(100 + seed, 100 + seed + live)), np.int32)
    slots = np.full((B,), sink, np.int32)
    slots[:live] = np.arange(live)
    pen = np.full((B, args.max_model_len if full else 1), -1, np.int32)
    ref = runner.sample_rows(logits + [logits[0]] * (B - live), mode, temps, tks, tps, pen,
                             freqs, press, seeds, np.zeros((B,), np.int32), slots, 0)
    first = ref.arrs[0].cpu().numpy()
    if full:
        pen[:live, 0] = first[:live]
    active = np.zeros((B,), bool)
    active[:live] = True
    return dict(
        K=K, mode=mode, tokens=np.zeros((B,), np.int32),
        chain=(list(range(live)), list(range(live))),
        positions=f([int(n) for n in lens], np.int32), tables=tab, active=active,
        temps=temps, seeds=seeds, steps0=f([1] * live, np.int32), tks=tks, tps=tps,
        freqs=freqs, press=press, pen=pen, fold_slots=slots,
        top_n=runner.args.top_logprobs_max,
    )


def _device_state(runner):
    return [t.clone() for t in runner.cache if t is not None] + [runner.last_toks.clone()]


def _restore(runner, state):
    for dst, src in zip([t for t in runner.cache if t is not None] + [runner.last_toks], state):
        dst.copy_(src)


def graph_vs_eager(runner, kw):
    """Run the window ``kw`` as a CUDA-graph replay and op by op from the
    same device state; raise unless outputs, KV pages (block 0, the garbage
    sink, aside) and the chain buffer (sink slot aside) are bit-identical.
    → the window's token ids."""
    import torch

    before = _device_state(runner)
    runs = []
    for eager in (False, True):
        _restore(runner, before)
        outs = [a.clone() for a in runner.multi_decode(**kw, eager=eager).arrs]
        runs.append((outs, _device_state(runner)))
    torch.cuda.synchronize()
    (g_out, g_state), (e_out, e_state) = runs
    names = ("tokens", "logprobs", "top_vals", "top_ids")
    for name, a, b in zip(names, g_out, e_out):
        if not torch.equal(a, b):
            raise RuntimeError(f"{kw['mode']}: graph and eager windows differ in {name}")
    for i, (a, b) in enumerate(zip(g_state, e_state)):
        a, b = (a[:-1], b[:-1]) if i == len(g_state) - 1 else (a[:, 1:], b[:, 1:])
        if not torch.equal(a, b):
            raise RuntimeError(f"{kw['mode']}: graph and eager windows differ in device state {i}")
    return g_out[0]


def chained_vs_drained(runner, kw):
    """Two windows back to back: the second dispatched before the first is
    fetched, chaining from the fold (depth 2), against the first fetched
    and the second fed its tokens from the host (depth 0). Raise unless
    both windows' outputs are bit-identical."""
    import numpy as np
    import torch

    K = kw["K"]
    live = len(kw["chain"][0])
    kw2 = dict(kw, positions=kw["positions"] + K, steps0=kw["steps0"] + K * kw["active"])
    before = _device_state(runner)
    r1 = runner.multi_decode(**kw)
    o1 = [a.clone() for a in r1.arrs]
    o2 = [a.clone() for a in runner.multi_decode(**kw2).arrs]
    _restore(runner, before)
    d1 = [a.clone() for a in runner.multi_decode(**kw).arrs]
    toks = np.zeros_like(kw["tokens"])
    toks[:live] = d1[0][-1].cpu().numpy()[:live]
    d2 = [a.clone() for a in runner.multi_decode(**dict(kw2, tokens=toks, chain=None)).arrs]
    torch.cuda.synchronize()
    for a, b in zip(o1 + o2, d1 + d2):
        if not torch.equal(a, b):
            raise RuntimeError(f"{kw['mode']}: chained windows differ from drained ones")


def profile_replay(runner, kw, card_line: str, label: str = "burst lengths") -> dict:
    """torch.profiler over one graph replay of the window ``kw`` (its rows
    named by ``label`` in the log): its kernels by family, device time per
    substep."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    runner.multi_decode(**kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        runner.multi_decode(**kw)
        torch.cuda.synchronize()
    K = kw["K"]
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.self_device_time_total > 0]
    families = {"int8 tied head": ("int8_matmul_tied", "int8_tied", "int8_matmul_t_"),
                "int8_matmul": ("int8_matmul",),
                "gemm (nvjet/cutlass/gemv)": ("nvjet", "gemm", "gemv", "cutlass", "splitK"),
                "paged_attention": ("paged_attention",), "copy": ("copy",),
                "reduce": ("reduce",), "index/scatter/gather": ("index", "scatter", "gather"),
                "sort/topk": ("sort", "topk", "Sort", "radix")}
    fam = {k: [0.0, 0] for k in [*families, "other elementwise"]}
    for key, ms, n in rows:
        name = next((f for f, pats in families.items() if any(p in key for p in pats)),
                    "other elementwise")
        fam[name][0] += ms / K
        fam[name][1] += n / K
    total = sum(v[0] for v in fam.values())
    kernels = sum(v[1] for v in fam.values())
    log(f"graphs: profiled replay ({kw['mode']}, {label}): {total:.3f} ms device time "
        f"and {kernels:.0f} kernels per substep ({card_line})")
    for name, (ms, n) in sorted(fam.items(), key=lambda kv: -kv[1][0]):
        log(f"graphs:   {ms:7.3f} ms {n:6.0f} kernels per substep  {name}")
    return {"ms_per_substep": total, "kernels_per_substep": kernels,
            "families": {k: {"ms": v[0], "kernels": v[1]} for k, v in fam.items()}}


def replay_ms(runner, kw) -> float:
    """Device time per substep of the window ``kw`` as one graph replay:
    the median of 5 CUDA-event timings after one warm replay."""
    import torch

    runner.multi_decode(**kw)
    times = []
    for _ in range(5):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        runner.multi_decode(**kw)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times) / kw["K"]


def replay_phase(engine, card_line: str, tag: str) -> dict:
    """An int8 run's window: the "simple" window at the burst's lengths on
    the engine's weights and KV page format (its own small cache), its
    replay device time per substep and one profiled replay by family."""
    from dynamo_tpu_torch.engine.config import EngineArgs
    from dynamo_tpu_torch.engine.runner import LocalRunner

    args = EngineArgs(model=engine.cfg, block_size=16, num_kv_blocks=256, max_num_seqs=8,
                      max_model_len=2048, decode_steps=8, dtype="bfloat16", device="cuda",
                      kv_quant=engine.args.kv_quant)
    runner = LocalRunner(args, params=engine.runner.params)
    runner.start()
    kw = dict(window_inputs(runner, "simple", 61, lens=BURST_HIST[:6]), top_n=0)
    ms = replay_ms(runner, kw)
    log(f"{tag}: simple window at the burst's lengths: {ms:.3f} ms device time per substep as "
        f"one graph replay ({card_line})")
    out = {"replay_ms_per_substep_simple": ms, "replay_profile": profile_replay(runner, kw, card_line)}
    runner.stop()
    return out


def window_phase(engine, card_line: str):
    """Graph vs eager at llama-8b shapes in every sampler mode, chained vs
    drained windows, and the threefry noise's device time per substep."""
    import torch

    from dynamo_tpu_torch.engine.config import EngineArgs
    from dynamo_tpu_torch.engine.runner import LocalRunner
    from dynamo_tpu_torch.engine.sampler import row_gumbel

    import numpy as np

    args = EngineArgs(model=engine.cfg, block_size=16, num_kv_blocks=256, max_num_seqs=8,
                      max_model_len=2048, decode_steps=8, dtype="bfloat16", device="cuda")
    runner = LocalRunner(args, params=engine.runner.params)
    runner.start()
    out = {}
    for i, mode in enumerate(("greedy", "simple", "full")):
        kw = window_inputs(runner, mode, 40 + i)
        toks = graph_vs_eager(runner, kw)
        log(f"graphs: {engine.cfg.name} K=8 {mode} window, graph replay bit-identical to eager "
            f"(tokens, logprobs, top-{kw['top_n']}, KV pages, chain buffer); row 1 tokens "
            f"{toks[:, 1].tolist()}")
        # One window at the burst's row lengths (W = 128): the replay's
        # device time, against the same window run op by op (host clock).
        kw = dict(window_inputs(runner, mode, 60 + i, lens=BURST_HIST[:6]), top_n=0)
        ms = replay_ms(runner, kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.multi_decode(**kw, eager=True)
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) * 1e3 / kw["K"]
        out[f"replay_ms_per_substep_{mode}"] = ms
        out[f"eager_ms_per_substep_{mode}"] = eager_ms
        log(f"graphs: {mode} window at the burst's lengths (W={np.shape(kw['tables'])[1]}): "
            f"{ms:.3f} ms device time per substep as one graph replay, {eager_ms:.3f} ms per "
            f"substep op by op (host clock) ({card_line})")
        if mode == "simple":
            out["replay_profile"] = profile_replay(runner, kw, card_line)
    chained_vs_drained(runner, window_inputs(runner, "simple", 50))
    log("graphs: two chained windows (depth 2) bit-identical to drained ones (depth 0)")

    B, V = 8, engine.cfg.vocab_size
    seeds = torch.arange(1000, 1000 + B, device="cuda")
    steps = torch.full((B,), 7, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            row_gumbel(seeds, steps, V)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        noise = row_gumbel(seeds, steps, V)
    graph.replay()
    torch.cuda.synchronize()
    if not torch.isfinite(noise).all():
        raise RuntimeError("threefry noise is not finite")
    times = []
    for _ in range(TIMED_RUNS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    ms = statistics.median(times)
    log(f"graphs: threefry Gumbel noise for {B} rows x {V} tokens (one sampled substep): "
        f"{ms:.4f} ms device time as one graph replay ({card_line})")
    runner.stop()
    out["threefry_ms"] = ms
    return out


def _counters(engine):
    """(decode substeps dispatched, host seconds per phase) so far; read
    while the engine is idle between request waves."""
    return engine.total_decode_steps, dict(engine.phase_s)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def small_reference(device):
    """test-tiny in float32: prefill + a greedy 8-step window with the
    kernel and with the plain attention, from identical caches."""
    import torch

    from dynamo_tpu_torch.engine import model as M
    from dynamo_tpu_torch.engine.config import ModelConfig

    cfg = ModelConfig.preset("test-tiny")
    params = M.init_params(cfg, device, torch.float32, seed=7)
    toks = torch.zeros(48, dtype=torch.int32, device=device)
    toks[:40] = torch.arange(1, 41, dtype=torch.int32, device=device)
    table = torch.tensor([1, 2, 3, 4, 5], dtype=torch.int32, device=device)
    one = lambda *v, dt=torch.int32: torch.tensor(v, dtype=dt, device=device)  # noqa: E731
    outs = {}
    for impl in ("cuda", "torch"):
        cache = M.init_kv_cache(cfg, 64, 16, torch.float32, device)
        logits = M.prefill(cfg, params, cache, toks, table, 0, 40)
        first = torch.argmax(logits).to(torch.int32).reshape(1)
        tk, lp, _, _ = M.multi_decode(
            cfg, 8, "greedy", 0, params, cache, first, one(40), table[None],
            one(True, dt=torch.bool), one(0.0, dt=torch.float32), [0], [0], attn_impl=impl)
        outs[impl] = (tk.cpu(), lp.cpu())
    if not torch.equal(outs["cuda"][0], outs["torch"][0]):
        raise RuntimeError("test-tiny greedy tokens differ between the kernel and the plain path")
    err = float((outs["cuda"][1] - outs["torch"][1]).abs().max())
    if err > 1e-4:
        raise RuntimeError(f"test-tiny logprobs differ by {err}")
    log(f"reference: test-tiny float32, 8 greedy tokens equal with the kernel and the plain "
        f"path, logprob max diff {err:.2e}")


# -- phase 7: the distributed serving path over HTTP ---------------------------


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class Proc:
    """A child process of the HTTP phase: stdout and stderr go to a log
    file under build/http_phase/ and, line by line, to ``lines``."""

    def __init__(self, name: str, argv: list[str], env: dict | None = None):
        self.name = name
        os.makedirs(os.path.join(HERE, "build", "http_phase"), exist_ok=True)
        self.log = open(os.path.join(HERE, "build", "http_phase", f"{name}.log"), "w")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", *argv], cwd=HERE, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
            env={**os.environ, "PYTHONPATH": HERE, "PYTHONUNBUFFERED": "1", **(env or {})})
        self.lines: list[str] = []
        self._cv = threading.Condition()
        self._reader = threading.Thread(target=self._pump, daemon=True)
        self._reader.start()

    def _pump(self) -> None:
        for line in self.proc.stdout:
            self.log.write(line)
            self.log.flush()
            with self._cv:
                self.lines.append(line.rstrip("\n"))
                self._cv.notify_all()
        with self._cv:
            self._cv.notify_all()

    def wait_for(self, pattern: str, timeout: float) -> tuple[re.Match, float]:
        """→ (the first line matching ``pattern``, seconds since launch)."""
        rx = re.compile(pattern)
        deadline = time.monotonic() + timeout
        seen = 0
        with self._cv:
            while True:
                for line in self.lines[seen:]:
                    m = rx.search(line)
                    if m:
                        return m, time.perf_counter() - self.t0
                seen = len(self.lines)
                if self.proc.poll() is not None and not self._reader.is_alive():
                    raise RuntimeError(f"{self.name} exited rc={self.proc.returncode}: "
                                       + " | ".join(self.lines[-15:]))
                left = deadline - time.monotonic()
                if left <= 0:
                    raise RuntimeError(f"{self.name}: no line matching {pattern!r} in {timeout}s: "
                                       + " | ".join(self.lines[-15:]))
                self._cv.wait(min(left, 0.5))

    def stop(self, timeout: float = 60.0) -> int:
        """SIGTERM, wait → the exit code."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout)
        finally:
            self._reader.join(5)
            self.log.close()
        return rc

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(10)
        if not self.log.closed:
            self._reader.join(5)
            self.log.close()


async def http_request(port: int, path: str, body=None, headers=None, method: str = "POST"):
    """One HTTP/1.1 request over a raw asyncio socket → (status, headers,
    [(arrival perf_counter, body piece)], send perf_counter). Chunked
    bodies come back one piece per chunk."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    data = b"" if body is None else json.dumps(body).encode()
    head = [f"{method} {path} HTTP/1.1", "Host: 127.0.0.1", "Connection: close",
            "Content-Type: application/json", f"Content-Length: {len(data)}"]
    head += [f"{k}: {v}" for k, v in (headers or {}).items()]
    t0 = time.perf_counter()
    writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + data)
    await writer.drain()
    try:
        status = int((await reader.readline()).split()[1])
        hdrs = {}
        while (line := await reader.readline()) not in (b"\r\n", b""):
            k, _, v = line.decode("latin-1").partition(":")
            hdrs[k.strip().lower()] = v.strip()
        pieces = []
        if hdrs.get("transfer-encoding") == "chunked":
            while (size := int((await reader.readline()).split(b";")[0], 16)) > 0:
                pieces.append((time.perf_counter(), await reader.readexactly(size)))
                await reader.readexactly(2)
            await reader.readline()
        else:
            n = int(hdrs.get("content-length", "0"))
            pieces.append((time.perf_counter(), await reader.readexactly(n)))
    finally:
        writer.close()
    return status, hdrs, pieces, t0


def sse_payloads(pieces) -> list[tuple[float, str]]:
    """Chunked SSE pieces → [(arrival time, data payload)]."""
    out, buf = [], b""
    for t, piece in pieces:
        buf += piece
        while b"\n\n" in buf:
            event, buf = buf.split(b"\n\n", 1)
            for line in event.split(b"\n"):
                if line.startswith(b"data: "):
                    out.append((t, line[6:].decode()))
    return out


async def http_completion(port: int, body: dict, trace_id: str) -> dict:
    """POST one completion (SSE or aggregate) with a W3C traceparent →
    its text, usage, finish reason, TTFT (streams) and latency."""
    kind = "chat" if "messages" in body else "completion"
    path = "/v1/chat/completions" if kind == "chat" else "/v1/completions"
    status, _hdrs, pieces, t0 = await http_request(
        port, path, body, {"traceparent": f"00-{trace_id}-{'1' * 16}-01"})
    out = {"status": status, "latency_s": pieces[-1][0] - t0 if pieces else None,
           "trace_id": trace_id, "stream": bool(body.get("stream"))}
    if status != 200:
        out["error"] = b"".join(p for _, p in pieces)[:300].decode("utf-8", "replace")
        return out
    if not body.get("stream"):
        resp = json.loads(b"".join(p for _, p in pieces))
        out.update(choice_view(kind, resp["choices"][0]), usage=resp["usage"], done=True)
        return out
    events = sse_payloads(pieces)
    out["done"] = bool(events) and events[-1][1] == "[DONE]"
    texts, usage, finish = [], None, None
    # A completion chunk goes out only with text; a chat stream's first
    # event (the role) goes out with its first token.
    first_event = events[0][0] - t0 if events and events[0][1] != "[DONE]" else None
    for _t, data in events:
        if data == "[DONE]":
            continue
        ev = json.loads(data)
        if "error" in ev:
            out["error"] = ev["error"]
            continue
        ch = ev["choices"][0]
        piece = (ch.get("delta") or {}).get("content") if kind == "chat" else ch.get("text")
        if piece:
            texts.append(piece)
        usage = ev.get("usage") or usage
        finish = ch.get("finish_reason") or finish
    out.update(text="".join(texts), usage=usage, finish=finish, first_event_s=first_event)
    return out


async def routed(port: int, trace_id: str) -> tuple[str, float | None]:
    """The frontend's record of one request: its ledger entry (looked up by
    trace id) → the TTFT the frontend saw, and the trace's router.attempt
    span → the instance the router chose. → (instance, ledger ttft_s)."""
    status, _, pieces, _ = await http_request(
        port, f"/debug/requests?trace_id={trace_id}", method="GET")
    records = json.loads(b"".join(p for _, p in pieces))["requests"]
    if status != 200 or not records or records[0]["status"] != "200":
        raise RuntimeError(f"http: no 200 ledger record for trace {trace_id}: {records}")
    _, _, pieces, _ = await http_request(port, f"/debug/traces/{trace_id}", method="GET")
    spans = json.loads(b"".join(p for _, p in pieces))["spans"]
    served = [s["attrs"]["instance"] for s in spans
              if s["name"] == "router.attempt" and s.get("status", "ok") == "ok"]
    if not served:
        raise RuntimeError(f"http: trace {trace_id} has no router.attempt span")
    return served[-1], records[0].get("ttft_s")


def msgpack_frame_us(reps: int = 2000) -> dict:
    """Microseconds to pack + unpack one frame with the port's pure-Python
    msgpack, for the two frames the serving path sends most: a decode
    window's delta (8 tokens with logprobs) and the longest burst request."""
    from dynamo_tpu_torch.runtime import msgpack_lite

    delta = {"t": "data", "id": "0" * 32, "payload": {
        "token_ids": [91234, 17, 40012, 3, 128000, 77, 1045, 9981],
        "log_probs": [-0.125, -2.5, -0.03125, -7.75, -1.0, -0.5, -3.25, -0.0625],
        "finish_reason": None}}
    request = {"t": "request", "id": "0" * 32, "subject": "dynamo/backend/generate",
               "headers": {"timeout_s": 60.0, "traceparent": "00-" + "1" * 32 + "-" + "2" * 16 + "-01"},
               "payload": {"model": "llama-8b", "token_ids": list(range(1536)),
                           "sampling": {"temperature": 0.7, "seed": 1007, "logprobs": False},
                           "stop": {"max_tokens": 64, "ignore_eos": True},
                           "eos_token_ids": [257]}}
    out = {}
    for name, frame in (("delta_8_tokens", delta), ("request_1536_tokens", request)):
        raw = msgpack_lite.packb(frame)
        if msgpack_lite.unpackb(raw) != frame:
            raise RuntimeError(f"msgpack_lite: {name} does not round-trip")
        t0 = time.perf_counter()
        for _ in range(reps):
            msgpack_lite.unpackb(msgpack_lite.packb(frame))
        out[name] = {"bytes": len(raw), "us": (time.perf_counter() - t0) / reps * 1e6}
    return out


def span_record_us(reps: int = 2000) -> float:
    """Microseconds to record one request's engine spans as TorchEngine
    does (engine.queue and engine.prefill as intervals, engine.decode
    started, then ended with its tokens) through a recorder with the
    phase-histogram sink and a trace exporter's sink: the cost per request
    on a host thread that waits for no lock (a worker's event loop also
    waits for the scheduler thread's interpreter lock)."""
    from dynamo_tpu_torch.runtime import tracing
    from dynamo_tpu_torch.runtime.logging import TraceContext
    from dynamo_tpu_torch.runtime.metrics import MetricsRegistry
    from dynamo_tpu_torch.runtime.trace_export import TraceExporter

    rec = tracing.SpanRecorder(capacity=4096, ledger_capacity=16)
    prev = tracing.set_recorder(rec)
    try:
        handle = tracing.install_metrics_sink(MetricsRegistry())
        rec.add_sink(TraceExporter(None, "timing", recorder=rec, max_buffer=4096)._on_span)
        parent = TraceContext.parse("00-" + "1" * 32 + "-" + "2" * 16 + "-01")
        t0 = time.perf_counter()
        for _ in range(reps):
            now = time.perf_counter()
            tracing.record_interval("engine.queue", parent, start=now, end=now)
            tracing.record_interval("engine.prefill", parent, start=now, end=now,
                                    prompt_tokens=1536, cached_blocks=0)
            span = tracing.start_span("engine.decode", parent=parent)
            span.set_attrs(tokens=BURST_TOKENS)
            span.end()
        us = (time.perf_counter() - t0) / reps * 1e6
        tracing.remove_metrics_sink(handle)
        return us
    finally:
        tracing.set_recorder(prev)


def kv_wire_timing(n_blocks: int = 47, reps: int = 3) -> dict:
    """Host seconds to move one streamed KV chunk of ``n_blocks`` llama-8b
    bf16 blocks (the 768-token prompt's export) through the wire, best of
    ``reps``: framing it (``chunk_to_frames`` + ``framing.pack_prefixed``,
    what the prefill worker's kv_fetch sends), reading it back (``unpackb`` +
    ``KvChunkAssembler``) and turning it into the engine's inject dict
    (``to_wire``, on the decode worker's event loop), and the chunk from an
    endpoint to a router over the runtime's TCP wire; each beside one copy
    of the same bytes into new memory (``tobytes``), so a time reads as a
    number of copies."""
    import numpy as np

    from dynamo_tpu_torch.runtime import framing, msgpack_lite
    from dynamo_tpu_torch.transfer.stream import KvChunk, KvChunkAssembler, chunk_to_frames

    rng = np.random.default_rng(0)
    shape = (32, n_blocks, 16, 1024)  # llama-8b: 32 layers, 16-token blocks, 8 x 128 lanes
    pages = tuple(rng.integers(0, 1 << 16, shape, dtype=np.uint16) for _ in range(2))
    chunk = KvChunk(block_offset=0, pages=pages, num_tokens=16 * n_blocks)
    # a response data frame's envelope, as the endpoint server packs it
    prefix = framing.map3_prefix("t", "data", "id", "0" * 32, "payload")
    best = {"memcpy_s": [], "pack_s": [], "unpack_s": [], "to_wire_s": []}
    for _ in range(reps):
        t0 = time.perf_counter()
        copies = [src.tobytes() for src in pages]
        t1 = time.perf_counter()
        del copies
        raw = [framing.pack_prefixed(prefix, f) for f in chunk_to_frames(0, chunk)]
        t2 = time.perf_counter()
        asm, got = KvChunkAssembler(), None
        for r in raw:
            got = asm.feed(msgpack_lite.unpackb(r[4:])["payload"]) or got
        t3 = time.perf_counter()
        wire = got.to_wire()
        t4 = time.perf_counter()
        for k, v in zip(best, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            best[k].append(v)
        if not all(np.array_equal(a, b) for a, b in zip(got.pages, pages)) or not wire["k"]:
            raise RuntimeError("kv wire: a chunk did not round-trip")
        n_frames, max_frame = len(raw), max(len(r) for r in raw)
        del raw, asm, got, wire  # each rep starts from the same free memory
    out = {k: min(v) for k, v in best.items()}
    out["runtime_s"] = min(asyncio.run(_runtime_pull(chunk)) for _ in range(reps))
    out.update(bytes=sum(p.nbytes for p in pages), frames=n_frames, max_frame=max_frame)
    return out


async def _runtime_pull(chunk) -> float:
    """Seconds for one chunk's frames from an endpoint of one runtime to a
    router of another in the same process, over the runtime's TCP wire
    (what kv_fetch does between the two workers, without their engines)."""
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.engine import Context
    from dynamo_tpu_torch.runtime.push_router import RouterMode
    from dynamo_tpu_torch.transfer.stream import KvChunkAssembler, chunk_to_frames

    url = f"memory://kv-wire-{os.getpid()}-{time.perf_counter_ns()}"
    server = await DistributedRuntime.create(store_url=url)
    client = await DistributedRuntime.create(store_url=url)
    try:
        async def frames(payload, ctx):
            for f in chunk_to_frames(0, chunk):
                yield f

        await server.namespace("kvwire").component("c").endpoint("kv").serve(frames)
        router = await client.namespace("kvwire").component("c").endpoint("kv").router(
            RouterMode.ROUND_ROBIN)
        await router.discovery.wait_for_instances(1)
        t0 = time.perf_counter()
        asm, got = KvChunkAssembler(), None
        async for f in router.generate({}, Context()):
            got = asm.feed(f) or got
        dt = time.perf_counter() - t0
        if got is None or got.num_blocks != chunk.num_blocks:
            raise RuntimeError("kv wire: the runtime pull lost the chunk")
        return dt
    finally:
        await client.shutdown()
        await server.shutdown()


def _metric(text: str, name: str) -> float | None:
    m = re.search(rf"^{re.escape(name)}(?:{{[^}}]*}})? ([0-9.eE+-]+)$", text, re.M)
    return float(m.group(1)) if m else None


def http_phase(card_line: str, reference: dict, inproc_tps: float,
               preset: str = "llama-8b", device: str = "cuda", dtype: str = "bfloat16",
               fleet: bool = False, sla_profile: str | None = None,
               control: dict | None = None) -> dict:
    """Phase 7: store + two workers + kv frontend as separate processes,
    the main path's burst over HTTP. ``reference``: the in-process burst's
    requests (``reference_entry``) under "burst", and request 7 served
    again on its cached prefix under "repeat". The workers publish their
    KV residency to the prefix directory and export their spans. With
    ``fleet``, phase 7b (``fleet_phase``) follows, after the single
    frontend has exited, in front of the same workers. With
    ``sla_profile`` (phase 4s's npz) the workers run ``--autoscaler on
    --sla-profile`` it, and with ``control`` (``control_phase``'s keyword
    arguments) phase 7c follows 7b over the same workers."""
    procs: list[Proc] = []
    store_port = _free_port()
    store_url = f"tcp://127.0.0.1:{store_port}"
    try:
        store = Proc("store", ["dynamo_tpu_torch.runtime.store_server", "--host", "127.0.0.1",
                               "--port", str(store_port)])
        procs.append(store)
        store.wait_for(r"store server: tcp://", 60)
        workers = []
        for i in range(2):
            sys_port = _free_port()
            w = Proc(f"worker{i}", [
                "dynamo_tpu_torch.worker", "--store-url", store_url, "--preset", preset,
                "--dtype", dtype, "--device", device, "--kv-directory", "on", *ENGINE_ARGV,
                *(["--autoscaler", "on", "--sla-profile", sla_profile] if sla_profile else [])],
                env={"DYNTPU_SYSTEM_ENABLED": "1", "DYNTPU_SYSTEM_PORT": str(sys_port),
                     "DYNTPU_TRACE_EXPORT": "1", "DYNTPU_FLEET_ID": FLEET_ID})
            w.sys_port = sys_port
            procs.append(w)
            workers.append(w)
        startup = []
        for w in workers:
            m, secs = w.wait_for(r"serving .* \((\d+) window graphs captured in ([0-9.]+)s", 600)
            startup.append({"launch_to_registered_s": secs, "graphs": int(m.group(1)),
                            "graph_warmup_s": float(m.group(2))})
            log(f"http: {w.name} registered {secs:.2f}s after launch, {m.group(1)} window graphs "
                f"captured in {m.group(2)}s ({card_line})")
        fe = Proc("frontend", ["dynamo_tpu_torch.frontend", "--store-url", store_url,
                               "--host", "127.0.0.1", "--port", "0", "--router-mode", "kv"])
        procs.append(fe)
        port = int(fe.wait_for(r"frontend: http://127\.0\.0\.1:(\d+)", 120)[0].group(1))
        result = asyncio.run(_drive_http(port, preset, reference, inproc_tps, card_line))
        rcs = {"frontend": fe.stop()}
        if fleet:
            result["fleet"] = fleet_phase(card_line, store_url, workers, reference, result,
                                          preset=preset, device=device)
            rcs["fleet"] = result["fleet"]["exit_code"]
        if control is not None:
            result["control"] = control_phase(card_line, store_url, workers, reference,
                                              sla_profile, preset=preset, device=device,
                                              **control)
            rcs.update(result["control"]["exit_codes"])

        for w in workers:
            _, _, pieces, _ = asyncio.run(http_request(w.sys_port, "/metrics", method="GET"))
            text = b"".join(p for _, p in pieces).decode()
            w.metrics = {k: _metric(text, f"dynamo_tpu_{k}") for k in (
                "engine_kv_cache_bytes", "engine_prefill_pad_ratio", "engine_inflight_windows",
                "engine_kv_quant_enabled")}
            if w.metrics["engine_kv_cache_bytes"] is None:
                raise RuntimeError(f"http: {w.name}'s /metrics has no engine series")
        rcs.update({p.name: p.stop() for p in [*workers, store]})
        if any(rcs.values()):
            raise RuntimeError(f"http: processes did not exit 0 on SIGTERM: {rcs}")
        per_worker, total = [], 0
        for w, st in zip(workers, startup):
            counters = next(json.loads(line) for line in reversed(w.lines)
                            if line.startswith('{"event": "engine_counters"'))
            launches, substeps = counters["paged_attention_launches"], counters["decode_substeps"]
            # On the CPU (a rehearsal) the plain attention runs: no launch.
            want = counters["num_layers"] * substeps if device == "cuda" else 0
            if launches != want:
                raise RuntimeError(f"http: {w.name} kernel launches {launches} != layers "
                                   f"{counters['num_layers']} x substeps {substeps}")
            total += launches
            per_worker.append({**st, **counters, "metrics": w.metrics})
            log(f"http: {w.name} paged_attention launches {launches} (= {want}: "
                f"{counters['num_layers']} layers x {substeps} substeps on the card, 0 on the CPU), "
                f"{counters['generated_tokens']} tokens generated, "
                f"eager windows {counters['eager_windows']}, /metrics {w.metrics}")
        if total <= 0 and device == "cuda":
            raise RuntimeError("http: no worker launched the kernel")
        log(f"http: every process exited 0 on SIGTERM ({rcs})")
        result.update(workers=per_worker, launches=total, exit_codes=rcs)
        return result
    finally:
        for p in procs:
            p.kill()


def choice_view(kind: str, choice: dict) -> dict:
    """An aggregate response's choice → its text, finish reason, and per
    token logprobs and token texts (chat: ``logprobs.content``)."""
    lp = choice.get("logprobs") or {}
    if kind == "chat":
        content = lp.get("content")
        return {"text": choice["message"]["content"], "finish": choice["finish_reason"],
                "logprobs": [e["logprob"] for e in content] if content else None,
                "lp_tokens": [e["token"] for e in content] if content else None}
    return {"text": choice["text"], "finish": choice["finish_reason"],
            "logprobs": lp.get("token_logprobs"), "lp_tokens": lp.get("tokens")}


async def clear_kv(port: int, model: str, workers: int = 2) -> dict[str, int]:
    """POST /clear_kv_blocks until a call drops nothing on any worker (a
    row still draining its last windows frees its blocks a moment after
    its response) → blocks dropped per instance."""
    await asyncio.sleep(1.0)
    total: dict[str, int] = {}
    for _ in range(50):
        status, _, pieces, _ = await http_request(port, "/clear_kv_blocks", {})
        cleared = json.loads(b"".join(p for _, p in pieces))["cleared"].get(model) or {}
        if status != 200 or len(cleared) != workers or any(n < 0 for n in cleared.values()):
            raise RuntimeError(f"http: /clear_kv_blocks answered {status}: {cleared}")
        for inst, n in cleared.items():
            total[inst] = total.get(inst, 0) + n
        if total and not any(cleared.values()):
            return total
        await asyncio.sleep(0.2)
    raise RuntimeError(f"http: the workers' caches never came up empty: {total}")


async def _drive_http(port: int, model: str, reference: dict, inproc_tps: float,
                      card_line: str) -> dict:
    for _ in range(600):
        _, _, pieces, _ = await http_request(port, "/v1/models", method="GET")
        if [m["id"] for m in json.loads(b"".join(p for _, p in pieces))["data"]] == [model]:
            break
        await asyncio.sleep(0.1)
    else:
        raise RuntimeError(f"http: the frontend never listed {model}")
    prompts = burst_prompts()

    def body(i: int, stream: bool) -> dict:
        return {"model": model, "prompt": prompts[i], "max_tokens": BURST_TOKENS,
                "temperature": BURST_TEMPS[i], "seed": 1000 + i, "ignore_eos": True,
                "logprobs": 0, "stream": stream}

    def check(label: str, r: dict, ref: dict | None) -> None:
        """200, [DONE], 64 tokens; against the in-process request: the same
        text and, for an aggregate response (which carries every token's
        text and logprob), the same 64 token texts and logprobs bit for bit."""
        if r["status"] != 200 or r.get("error"):
            raise RuntimeError(f"http {label}: status {r['status']} {r.get('error')}")
        if not r["done"]:
            raise RuntimeError(f"http {label}: the stream did not end in [DONE]")
        if (r["usage"] or {}).get("completion_tokens") != BURST_TOKENS or r["finish"] != "length":
            raise RuntimeError(f"http {label}: usage {r['usage']}, finish {r['finish']!r}")
        if ref is None:
            return
        if r["text"] != ref["text"]:
            raise RuntimeError(f"http {label}: text differs from the in-process request's")
        if not r["stream"] and (r["logprobs"] != ref["logprobs"]
                                or r["lp_tokens"] != ref["lp_tokens"]):
            raise RuntimeError(f"http {label}: token logprobs differ from the in-process request's")

    async def burst_pass(n: int, sse: bool) -> dict:
        """All 8 at once, the even ones streamed if ``sse``, the others
        aggregated; every aggregate one held to the in-process burst bit
        for bit."""
        t0 = time.perf_counter()
        rs = await asyncio.gather(*(
            http_completion(port, body(i, sse and i % 2 == 0), f"{0xB00 + 0x10 * n + i:032x}")
            for i in range(8)))
        wall = time.perf_counter() - t0
        for i, r in enumerate(rs):
            check(f"pass {n} request {i} ({'SSE' if r['stream'] else 'aggregate'})", r,
                  reference["burst"][i])
        seen = [await routed(port, r["trace_id"]) for r in rs]
        tps = 8 * BURST_TOKENS / wall
        instances = [inst for inst, _ in seen]
        log(f"http: pass {n}: 8 requests ({'4 SSE, 4' if sse else 'all 8'} aggregate), "
            f"{8 * BURST_TOKENS} completion tokens in "
            f"{wall:.3f}s → {tps:.1f} tokens/s over HTTP against {inproc_tps:.1f} in process "
            f"({tps / inproc_tps:.3f}x); routed to instances "
            + ", ".join(f"{i}:{inst}" for i, inst in enumerate(instances)) + f" ({card_line})")
        return {"responses": rs, "wall": wall, "tps": tps, "instances": instances,
                "ledger_ttft": [t for _, t in seen]}

    # Pass 1: the burst, even requests streamed, odd aggregated.
    one = await burst_pass(1, sse=True)
    burst, wall, tps, instances = one["responses"], one["wall"], one["tps"], one["instances"]
    if len(set(instances)) != 2:
        raise RuntimeError(f"http: the kv router used {len(set(instances))} of 2 workers")

    # Two chat completions, the same greedy request streamed and aggregated.
    chat = {"model": model, "max_tokens": BURST_TOKENS, "temperature": 0.0, "seed": 42,
            "ignore_eos": True,
            "messages": [{"role": "system", "content": "You are a helpful assistant."},
                         {"role": "user", "content": prompts[2]}]}
    chats = await asyncio.gather(http_completion(port, dict(chat, stream=True), f"{0xC0:032x}"),
                                 http_completion(port, dict(chat, stream=False), f"{0xC1:032x}"))
    for r in chats:
        check(f"chat ({'SSE' if r['stream'] else 'aggregate'})", r, None)
    if chats[0]["text"] != chats[1]["text"]:
        raise RuntimeError("http: the streamed and aggregated chat completions differ")
    log(f"http: two chat completions (SSE and aggregate) of 64 tokens, equal; the SSE one's "
        f"first event (its first token) after {chats[0]['first_event_s'] * 1e3:.1f} ms "
        f"({card_line})")

    # One burst prompt again: the KV router must send it to the worker
    # holding its prefix (the longest prompt: 96 cached blocks). Only its
    # last block is prefilled, attending over the cached pages: its token
    # stream must equal the in-process engine's on the same prefix hit.
    again = await http_completion(port, body(7, False), f"{0xD7:032x}")
    check("repeated request 7", again, reference["repeat"])
    drift = max(abs(a - b) for a, b in zip(again["logprobs"], reference["burst"][7]["logprobs"]))
    inst, again_ttft = await routed(port, again["trace_id"])
    if inst != instances[7]:
        raise RuntimeError(f"http: repeated request 7 went to instance {inst}, not {instances[7]} "
                           "which holds its prefix")
    log(f"http: repeated request 7 routed to instance {inst} again (its prefix holder); its 64 "
        f"token texts and logprobs equal the in-process prefix-hit pass's bit for bit (max "
        f"|logprob - cold pass| {drift:.3g}); frontend ledger TTFT {again_ttft * 1e3:.1f} ms, "
        f"latency {again['latency_s'] * 1e3:.1f} ms ({card_line})")

    # Pass 2, from empty caches: the same burst all aggregated, so every
    # request is held bit for bit, on whichever worker serves it.
    cleared = await clear_kv(port, model)
    log(f"http: /clear_kv_blocks dropped {cleared} cached blocks per instance")
    two = await burst_pass(2, sse=False)
    held = {inst for p in (one, two) for inst, r in zip(p["instances"], p["responses"])
            if not r["stream"]}
    if held != set(instances):
        raise RuntimeError(f"http: only instances {held} served a request held bit for bit")
    visible = sum(len(r["text"]) for r in burst)
    # TTFT: the frontend ledger's, for the aggregate requests of both
    # passes (a completion's SSE chunk waits for visible text, and random
    # weights mostly emit ids the byte tokenizer renders as nothing).
    ttfts = sorted(t for p in (one, two) for t, r in zip(p["ledger_ttft"], p["responses"])
                   if not r["stream"])
    log(f"http: frontend ledger TTFT of the {len(ttfts)} aggregate requests (4 in pass 1, 8 in "
        f"pass 2) p50 "
        f"{statistics.median(ttfts) * 1e3:.1f} ms, max {max(ttfts) * 1e3:.1f} ms; in process "
        + ", ".join(f"{ref['ttft_s'] * 1e3:.0f}" for ref in reference["burst"])
        + " ms for requests 0-7; pass 1 client latencies " + ", ".join(
            f"{r['latency_s'] * 1e3:.0f}" for r in burst) + f" ms ({card_line})")
    log(f"http: every completion's text ({visible} visible characters in pass 1) equals the "
        "in-process burst's, and the 64 token texts and logprobs of every aggregate one (4 in "
        f"pass 1, 8 in pass 2) equal it bit for bit, on instances {sorted(held)}")
    return {"tokens_per_s": tps, "inproc_tokens_per_s": inproc_tps, "wall_s": wall,
            "tokens_per_s_pass2": two["tps"], "wall_s_pass2": two["wall"],
            "ttft_p50_s": statistics.median(ttfts), "ttft_max_s": max(ttfts),
            "ttft_s": one["ledger_ttft"], "ttft_s_pass2": two["ledger_ttft"],
            "latency_s": [r["latency_s"] for r in burst], "instances": instances,
            "instances_pass2": two["instances"], "visible_chars": visible,
            "cleared_blocks": cleared,
            "chat_first_event_s": chats[0]["first_event_s"], "repeat_ttft_s": again_ttft,
            "repeat_latency_s": again["latency_s"], "repeat_logprob_drift": drift}


# -- phase 7b: a frontend fleet in front of phase 7's workers ------------------

FLEET_ID = "chip-smoke"
NAMESPACE = "dynamo"
# Phase 7's SSE/aggregate requests and the fleet's are all BURST_TOKENS
# long, so a worker's requests are its generated tokens / BURST_TOKENS.
EARLIER_HTTP_TPS = "206.7-220.9"  # phase 7's tokens/s in PERF.md's earlier chip runs


def _phase_count(text: str, phase: str, field: str = "count") -> float:
    """``phase_duration_seconds_<field>{phase=...}`` from a /metrics text,
    the span count or (``field="sum"``) their seconds; 0 if absent."""
    m = re.search(rf'^dynamo_tpu_phase_duration_seconds_{field}\{{[^}}]*phase="'
                  + re.escape(phase) + r'"[^}]*\} ([0-9.eE+-]+)$', text, re.M)
    return float(m.group(1)) if m else 0.0


def fleet_phase(card_line: str, store_url: str, workers: list, reference: dict,
                phase7: dict, preset: str = "llama-8b", device: str = "cuda") -> dict:
    """Phase 7b: phase 7's single frontend is gone; a fleet of two port
    frontends (``--fleet 2``, one shared port, a global budget of 16, the
    kv router, trace export on) serves phase 7's burst, its two chats and
    its repeat of request 7 through the port's ``OpenAIClient``, in front
    of the same store and workers (started with ``--kv-directory on`` and
    trace export). ``workers``: phase 7's worker ``Proc``s, each with its
    ``sys_port``."""
    t_phase = time.perf_counter()
    before = {w.name: settled_counters(w) for w in workers}
    admin_port = _free_port()
    fleet = Proc("fleet", ["dynamo_tpu_torch.frontend", "--store-url", store_url,
                           "--host", "127.0.0.1", "--port", "0", "--router-mode", "kv",
                           "--fleet", "2", "--fleet-id", FLEET_ID,
                           "--fleet-admin-port", str(admin_port),
                           "--global-max-inflight", "16"],
                 env={"DYNTPU_TRACE_EXPORT": "1"})
    try:
        m, _ = fleet.wait_for(r"fleet: http://127\.0\.0\.1:(\d+) admin http://127\.0\.0\.1:(\d+)",
                              120)
        port, admin = int(m.group(1)), int(m.group(2))
        _, ready_s = fleet.wait_for(r"fleet ready", 120)
        log(f"fleet: two frontends registered and serving on port {port} {ready_s:.2f}s after "
            f"launch, admin on {admin}")
        res = asyncio.run(_drive_fleet(port, admin, store_url, preset, reference, card_line))
        res["ready_s"] = ready_s
        after = {w.name: settled_counters(w) for w in workers}
        per_worker, launches = {}, 0
        for w in workers:
            text = _get_text(w.sys_port, "/metrics")
            decodes = _phase_count(text, "engine.decode")
            b, a = before[w.name], after[w.name]
            served = a["generated_tokens"] // BURST_TOKENS
            if a["generated_tokens"] % BURST_TOKENS or decodes != served:
                raise RuntimeError(f"fleet: {w.name}'s /metrics counts {decodes:.0f} engine.decode "
                                   f"spans for {a['generated_tokens']} generated tokens "
                                   f"({BURST_TOKENS} a request)")
            d_launch = a["paged_attention_launches"] - b["paged_attention_launches"]
            d_sub = a["decode_substeps"] - b["decode_substeps"]
            want = a["num_layers"] * d_sub if device == "cuda" else 0
            if d_launch != want:
                raise RuntimeError(f"fleet: {w.name} launched attention {d_launch} times over "
                                   f"{d_sub} substeps of {a['num_layers']} layers")
            launches += d_launch
            tr = a["trace"]
            per_worker[w.name] = {"engine_decode_spans": decodes, "requests": served,
                                  "fleet_requests": served - b["generated_tokens"] // BURST_TOKENS,
                                  "launches": d_launch, "substeps": d_sub, "trace": tr}
        if sum(v["fleet_requests"] for v in per_worker.values()) != res["requests"]:
            raise RuntimeError(f"fleet: the workers served {per_worker} of {res['requests']} "
                               "fleet requests")
        if device == "cuda" and launches <= 0:
            raise RuntimeError("fleet: no worker launched the kernel")
        # Host cost of tracing in the workers, per request: the event loop's
        # wall time recording the engine spans and in the exporter's sink (a
        # wait for the interpreter lock included: the serving path waits it
        # too); the exporter's store flushes (awaited) apart.
        reqs = sum(v["trace"]["requests"] for v in per_worker.values())
        span_us = 1e6 * sum(v["trace"]["span_s"] for v in per_worker.values()) / reqs
        sink_us = 1e6 * sum(v["trace"]["export_sink_s"] for v in per_worker.values()) / reqs
        flush_us = 1e6 * sum(v["trace"]["export_flush_s"] for v in per_worker.values()) / reqs
        rc = fleet.stop()
        if rc != 0:
            raise RuntimeError(f"fleet: the supervisor exited {rc} on SIGTERM")
        res.update(workers=per_worker, launches=launches, exit_code=rc,
                   phase_s=time.perf_counter() - t_phase,
                   trace_us_per_request={"spans": span_us, "export_sink": sink_us,
                                         "export_flush_wall": flush_us, "requests": reqs})
        log(f"fleet: burst {res['tokens_per_s']:.1f} tokens/s through two frontends against phase "
            f"7's {phase7['tokens_per_s']:.1f} through one (phase 7 in PERF.md's earlier runs: "
            f"{EARLIER_HTTP_TPS}); ledger TTFT p50 {res['ttft_p50_s'] * 1e3:.1f} ms, max "
            f"{res['ttft_max_s'] * 1e3:.1f} ms against phase 7's {phase7['ttft_p50_s'] * 1e3:.1f} / "
            f"{phase7['ttft_max_s'] * 1e3:.1f} ms ({card_line})")
        log(f"fleet: tracing in the workers over {reqs} traced requests, event-loop wall time "
            f"per request: recording the engine spans {span_us:.1f} us (their recorder sinks "
            f"included, the exporter's among them); the exporter's sink over all of a worker's "
            f"spans {sink_us:.1f} us; its store flushes {flush_us:.1f} us, awaited (host CPU "
            f"beside {card_line})")
        log(f"fleet: attention launches {launches} over the fleet's requests (= layers x "
            f"substeps on each worker); the supervisor exited 0 on SIGTERM; phase 7b took "
            f"{res['phase_s']:.1f}s")
        return res
    finally:
        if fleet.proc.poll() is None:
            # SIGTERM first: the supervisor stops its children; a SIGKILL
            # would leave them serving.
            try:
                fleet.stop(60)
            except subprocess.TimeoutExpired:
                fleet.kill()


FLEET_EXTRA_REPEATS = 16  # at most: each misses the idle child with odds 1/2


def served_by_child(metrics: str) -> dict[str, float]:
    """The fleet's aggregated /metrics → 200 responses by child."""
    served: dict[str, float] = {}
    for line in metrics.splitlines():
        if line.startswith("dynamo_tpu_http_requests_total{") and 'status="200"' in line:
            wid = line.split('fleet_worker_id="')[1].split('"')[0]
            served[wid] = served.get(wid, 0) + float(line.rsplit(" ", 1)[1])
    return served


async def _drive_fleet(port: int, admin: int, store_url: str, model: str, reference: dict,
                       card_line: str) -> dict:
    from dynamo_tpu_torch.fleet.directory import kvdir_prefix
    from dynamo_tpu_torch.llm.client import OpenAIClient
    from dynamo_tpu_torch.runtime.store import connect_store
    from dynamo_tpu_torch.tokens import compute_block_hashes

    base, admin_url = f"http://127.0.0.1:{port}", f"http://127.0.0.1:{admin}"
    prompts = burst_prompts()
    sent: list[dict] = []  # every request the fleet served: trace id, prompt tokens

    def client(trace_id: str) -> OpenAIClient:
        return OpenAIClient(base, timeout=300.0, max_retries=0, default_model=model,
                            headers={"traceparent": f"00-{trace_id}-{'2' * 16}-01"})

    async def completion(i: int, trace_id: str) -> dict:
        async with client(trace_id) as c:
            resp = await c.completion(prompts[i], max_tokens=BURST_TOKENS,
                                      temperature=BURST_TEMPS[i], seed=1000 + i,
                                      ignore_eos=True, logprobs=0)
        out = {**choice_view("completion", resp["choices"][0]), "usage": resp["usage"],
               "trace_id": trace_id}
        sent.append({"trace_id": trace_id, "prompt_tokens": len(prompts[i]), "index": i})
        return out

    def hold(label: str, r: dict, ref: dict) -> None:
        if (r["usage"] or {}).get("completion_tokens") != BURST_TOKENS or r["finish"] != "length":
            raise RuntimeError(f"fleet {label}: usage {r['usage']}, finish {r['finish']!r}")
        if (r["text"], r["logprobs"], r["lp_tokens"]) != (ref["text"], ref["logprobs"],
                                                           ref["lp_tokens"]):
            raise RuntimeError(f"fleet {label}: text, token texts or logprobs differ from phase "
                               "7's reference")

    async with OpenAIClient(base, timeout=30.0, default_model=model) as c:
        for _ in range(600):
            if await c.models() == [model]:
                break
            await asyncio.sleep(0.1)
        else:
            raise RuntimeError(f"fleet: the children never listed {model}")
    async def directory() -> dict[int, set]:
        """The prefix directory's holdings: instance → block hashes."""
        store = await connect_store(store_url)
        try:
            return {int(v["w"]): {int(h, 16) for h in v["h"]}
                    for v in (json.loads(e.value)
                              for e in await store.get_prefix(kvdir_prefix(NAMESPACE)))}
        finally:
            await store.close()

    def hashes_of(i: int) -> list[int]:
        ids = list(prompts[i].encode())
        return compute_block_hashes(ids, 16)[: (len(ids) - 1) // 16]

    # Cold caches: phase 7 holds its cold burst bit for bit, so this one is
    # served cold too (a bf16 prefix hit is not bit-identical to a cold
    # prefill).
    cleared = await clear_kv(port, model)
    listed_after_clear = {w: len(hs) for w, hs in (await directory()).items()}

    t0 = time.perf_counter()
    burst = await asyncio.gather(*(completion(i, f"{0xF00 + i:032x}") for i in range(8)))
    wall = time.perf_counter() - t0
    for i, r in enumerate(burst):
        hold(f"burst request {i}", r, reference["burst"][i])

    # Phase 7's chat, streamed (SSE through chat_stream) and aggregated.
    chat = [{"role": "system", "content": "You are a helpful assistant."},
            {"role": "user", "content": prompts[2]}]
    kw = {"max_tokens": BURST_TOKENS, "temperature": 0.0, "seed": 42, "ignore_eos": True}
    t0 = time.perf_counter()
    first_chunk_s, pieces = None, []
    async with client(f"{0xFC0:032x}") as c:
        async for ch in c.chat_stream(chat, **kw):
            first_chunk_s = first_chunk_s if first_chunk_s is not None else time.perf_counter() - t0
            if ch.get("choices"):
                pieces.append((ch["choices"][0].get("delta") or {}).get("content") or "")
    async with client(f"{0xFC1:032x}") as c:
        agg = await c.chat(chat, **kw)
    for tid in (f"{0xFC0:032x}", f"{0xFC1:032x}"):
        sent.append({"trace_id": tid, "prompt_tokens": None, "index": None})
    if "".join(pieces) != agg["choices"][0]["message"]["content"]:
        raise RuntimeError("fleet: the streamed and aggregated chats differ")
    if agg["usage"]["completion_tokens"] != BURST_TOKENS:
        raise RuntimeError(f"fleet: the chat's usage is {agg['usage']}")

    # Request 7 again, on its cached prefix.
    again = await completion(7, f"{0xFD7:032x}")
    hold("repeated request 7", again, reference["repeat"])

    # Both children on the one port: the kernel picks a child for each
    # connection by a hash of its addresses, so the 11 connections above
    # leave one child idle about once in 1,024 runs. Further repeats of
    # request 7, each on a connection of its own and each held as the
    # repeat is, until both children have served one.
    repeats = [f"{0xFD7:032x}"]
    for k in range(FLEET_EXTRA_REPEATS):
        async with OpenAIClient(admin_url, timeout=30.0) as a:
            if set(served_by_child((await a.get("/metrics")).text)) == {"0", "1"}:
                break
        repeats.append(f"{0xFE00 + k:032x}")
        hold(f"repeat {k + 2} of request 7", await completion(7, repeats[-1]),
             reference["repeat"])

    # The stitched traces: the supervisor's view of every request.
    async def fleet_trace(tid: str) -> dict:
        """Poll until the workers' exported engine spans have arrived."""
        async with OpenAIClient(admin_url, timeout=30.0) as a:
            for _ in range(100):
                r = await a.get(f"/debug/fleet/traces/{tid}")
                body = r.json() if r.status == 200 else {}
                names = {d["name"] for d in body.get("spans", ())}
                if {"engine.queue", "engine.prefill", "engine.decode"} <= names:
                    return body
                await asyncio.sleep(0.1)
        raise RuntimeError(f"fleet: trace {tid} never held the engine spans: {sorted(names)}")

    instances = {}
    for s in sent:
        spans = (await fleet_trace(s["trace_id"]))["spans"]
        by = {}
        for d in spans:
            by.setdefault(d["name"], []).append(d)
        lanes = {d["proc"] for d in spans}
        if not any("frontend-" in ln for ln in lanes) or not any("worker-" in ln for ln in lanes):
            raise RuntimeError(f"fleet: trace {s['trace_id']} lanes {sorted(lanes)}")
        s["worker_lane"] = next(d["proc"] for d in by["engine.decode"])
        # Each hop of the request, for a failure's message: the router's
        # attempts, the wire calls' addresses and the serving lanes.
        s["hops"] = [(d["name"], d["proc"], d["attrs"].get("instance") or d["attrs"].get("addr"),
                      d.get("status")) for d in spans
                     if d["name"] in ("router.attempt", "wire.call", "wire.serve",
                                      "engine.prefill", "engine.decode")]
        pre, dec = by["engine.prefill"][0]["attrs"], by["engine.decode"][0]["attrs"]
        if s["prompt_tokens"] is not None and pre["prompt_tokens"] != s["prompt_tokens"]:
            raise RuntimeError(f"fleet: engine.prefill prompt_tokens {pre['prompt_tokens']} != "
                               f"{s['prompt_tokens']}")
        if dec.get("tokens") != BURST_TOKENS:
            raise RuntimeError(f"fleet: engine.decode tokens {dec.get('tokens')}")
        s["cached_blocks"] = pre["cached_blocks"]
        # The frontend's placement (a worker's own router.attempt spans are
        # its peer prefix fetches: the directory may name another holder).
        served = [d["attrs"]["instance"] for d in by.get("router.attempt", ())
                  if "frontend-" in d["proc"] and d.get("status", "ok") == "ok"]
        if not served:
            raise RuntimeError(f"fleet: trace {s['trace_id']} has no frontend router.attempt span")
        instances[s["trace_id"]] = int(served[-1], 16)
    cold = [s["cached_blocks"] for s in sent[:8]]
    warm = [s["cached_blocks"] for s in sent if s["trace_id"] in repeats]
    if any(cold) or min(warm) <= 0:
        raise RuntimeError(f"fleet: cached_blocks {cold} on the cold burst, {warm} on the "
                           "repeats")
    strays = [t for t in repeats if instances[t] != instances[f"{0xF07:032x}"]]
    if strays:
        seven = set(hashes_of(7))
        raise RuntimeError(
            f"fleet: the repeat {strays[0]} of request 7 went to instance {instances[strays[0]]:x} "
            f"({sent[-1]['cached_blocks']} cached blocks), not to {instances[f'{0xF07:032x}']:x} "
            f"which served it in the burst; the directory listed {listed_after_clear} blocks "
            f"by instance after the clear ({cleared} cleared) and now lists request 7's "
            f"{ {w: len(hs & seven) for w, hs in (await directory()).items()} }; by request "
            + str([(s["index"], f"{instances[s['trace_id']]:x}", s["cached_blocks"],
                    s["worker_lane"], s["hops"]) for s in sent]))

    # The aggregated ledger: every request's record carries the engine phases.
    async with OpenAIClient(admin_url, timeout=30.0) as a:
        records = {r["trace_id"]: r for r in (await a.get("/debug/requests")).json()["requests"]}
        status = (await a.get("/fleet")).json()
        metrics = (await a.get("/metrics")).text
    ttfts = []
    for s in sent:
        rec = records.get(s["trace_id"])
        if rec is None or rec["status"] != "200":
            raise RuntimeError(f"fleet: no 200 ledger record for {s['trace_id']}")
        if not all(rec["phases"].get(p, 0) > 0 for p in ("queue_wait", "prefill", "decode",
                                                         "route", "wire")):
            raise RuntimeError(f"fleet: ledger phases {rec['phases']}")
        if s["index"] is not None and s["trace_id"] not in repeats:
            ttfts.append(rec["ttft_s"])

    # Both children registered on the one port and served.
    served_by = served_by_child(metrics)
    ws = status["workers"]
    if [(w["alive"], w["registered"]) for w in ws] != [(True, True)] * 2 or status["port"] != port:
        raise RuntimeError(f"fleet: /fleet says {status}")
    if set(served_by) != {"0", "1"}:
        raise RuntimeError(f"fleet: the children served {served_by}")

    # The directory: each burst request's full prompt blocks under the
    # instance that served it.
    want: dict[int, set] = {}
    for s in sent[:8]:
        want.setdefault(instances[s["trace_id"]], set()).update(hashes_of(s["index"]))
    for _ in range(100):
        held = await directory()
        missing = {inst: len(hs - held.get(inst, set())) for inst, hs in want.items()}
        if not any(missing.values()):
            break
        await asyncio.sleep(0.1)
    else:
        where = {s["index"]: {"instance": f"{instances[s['trace_id']]:x}",
                              "lane": s["worker_lane"], "cached": s["cached_blocks"],
                              "listed_by": {f"{w:x}": len(set(hashes_of(s["index"])) & hs)
                                            for w, hs in held.items()}} for s in sent[:8]}
        raise RuntimeError(f"fleet: the directory lacks burst blocks by instance: {missing}; "
                           f"entries {({f'{k:x}': len(v) for k, v in held.items()})}, after the "
                           f"clear {listed_after_clear}; by request {where}; hops "
                           + str({s["index"]: s["hops"] for s in sent[:8]}))
    log(f"fleet: 8 burst completions, 2 chats (SSE through chat_stream, aggregate) and "
        f"{len(repeats)} repeat(s) of request 7 through OpenAIClient; every burst response's 64 "
        f"token texts and logprobs equal phase 7's reference bit for bit, the repeat "
        f"({sent[-1]['cached_blocks']} cached blocks) on its prefix holder {instances[f'{0xFD7:032x}']}; every stitched trace holds a "
        f"frontend and a worker lane with engine.queue/prefill/decode; children served "
        f"{served_by}; the directory lists {sum(len(v) for v in want.values())} burst blocks "
        f"under {len(want)} instance(s) ({card_line})")
    return {"requests": len(sent), "wall_s": wall, "tokens_per_s": 8 * BURST_TOKENS / wall,
            "ttft_s": ttfts, "ttft_p50_s": statistics.median(ttfts), "ttft_max_s": max(ttfts),
            "chat_first_chunk_s": first_chunk_s, "cleared_blocks": cleared,
            "instances": [instances[s["trace_id"]] for s in sent],
            "cached_blocks_repeat": sent[-1]["cached_blocks"], "served_by_child": served_by,
            "extra_repeats": len(repeats) - 1,
            "directory_blocks": sum(len(v) for v in want.values())}


# -- phase 7c: the control plane over phase 7's workers -------------------------

PLANNER_ID = "chip-smoke"
# The planner leg: completions through the --qos frontend, greedy, top-2
# logprobs (the gap rule reads them), long enough to outlast the pool move
# and the relocation of the moved worker's streams.
PLAN_LENS = [256, 320, 384, 448, 512, 576]
PLAN_TOKENS = 1000  # ~10 s a stream at ~100 tokens/s: the move and relocations run inside
# The balancer leg: rows pinned on one worker, the other idle; the
# balancer moves one of them. Distinct prompts: every row's prefill is
# cold in both passes (a prefix hit is not bit-identical to a cold
# prefill, and which rows of a wave hit depends on admission timing).
BAL_ROWS = 7
BAL_LEN = 576
BAL_TOKENS = 768
BAL_SATURATION = 0.35  # 7 of 8 slots score ~0.45 (batch 0.5 x 7/8 + KV); 3 of 8 under 0.25
BAL_IDLE = 0.20
PLAN_COOLDOWN = 600.0  # one pool move, one balancer move per phase


def plan_prompts() -> list[str]:
    import numpy as np

    rng = np.random.default_rng(2026)
    return ["".join(chr(c) for c in rng.integers(32, 127, n)) for n in PLAN_LENS]


def balance_requests(model: str, max_tokens: int = BAL_TOKENS) -> list[dict]:
    """The balancer leg's rows: BAL_LEN-token byte prompts, greedy, top-2
    logprobs."""
    import numpy as np

    rng = np.random.default_rng(2027)
    return [{"model": model, "token_ids": [int(c) for c in rng.integers(32, 127, BAL_LEN)],
             "sampling": {"temperature": 0.0, "seed": 4000 + i, "logprobs": True,
                          "top_logprobs": 2},
             "stop": {"max_tokens": max_tokens, "ignore_eos": True}}
            for i in range(BAL_ROWS)]


def planner_argv(store_url: str, fe_port: int, ttft_sla_ms: float, itl_sla_ms: float,
                 interval: float, decision_log: str) -> list[str]:
    """The closed loop's CLI: the card's profile from discovery, one pool
    move and one balancer move at most (the cooldowns outlast the phase)."""
    return ["--operate", "--profile-from-discovery", "--store-url", store_url,
            "--metrics-url", f"http://127.0.0.1:{fe_port}/metrics", "--namespace", NAMESPACE,
            "--operator-id", PLANNER_ID, "--adjustment-interval", str(interval),
            "--hysteresis-cycles", "2", "--cooldown", str(PLAN_COOLDOWN),
            "--ttft-sla-ms", f"{ttft_sla_ms:.6f}", "--itl-sla-ms", f"{itl_sla_ms:.6f}",
            "--balance", "on", "--balance-saturation", str(BAL_SATURATION),
            "--balance-idle", str(BAL_IDLE), "--balance-cooldown", str(PLAN_COOLDOWN),
            "--decision-log", decision_log]


def recorded_streams(path: str) -> dict[str, dict]:
    """A frontend's ``--record-dir`` file → per request (context id) its
    prompt ids and its legs: token ids, logprobs, top-2 pairs and the
    arrival time of each leg's first and last token frame; a leg ends at
    a migration marker frame."""
    out: dict[str, dict] = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            rid = rec.get("rid")
            if rid is None:
                continue
            r = out.setdefault(rid, {"prompt": None, "legs": []})
            if rec["kind"] == "request":
                if r["prompt"] is None:
                    r["prompt"] = (rec.get("request") or {}).get("token_ids")
                r["legs"].append({"tokens": [], "logprobs": [], "top": [], "first": None,
                                  "last": None, "marker": None, "finish": None})
                continue
            item = rec.get("item") or {}
            leg = r["legs"][-1]
            if item.get("token_ids"):
                leg["tokens"] += item["token_ids"]
                leg["logprobs"] += item.get("log_probs") or []
                leg["top"] += item.get("top_log_probs") or []
                leg["first"] = leg["first"] if leg["first"] is not None else rec["t"]
                leg["last"] = rec["t"]
            if item.get("migration") is not None:
                leg["marker"] = rec["t"]
            leg["finish"] = item.get("finish_reason") or leg["finish"]
    for r in out.values():
        legs = r["legs"]
        r["tokens"] = [t for lg in legs for t in lg["tokens"]]
        r["logprobs"] = [x for lg in legs for x in lg["logprobs"]]
        r["top"] = [x for lg in legs for x in lg["top"]]
        r["finish"] = legs[-1]["finish"] if legs else None
    return out


def control_phase(card_line: str, store_url: str, workers: list, reference: dict,
                  profile_path: str, preset: str = "llama-8b", device: str = "cuda",
                  plan_tokens: int = PLAN_TOKENS, bal_tokens: int = BAL_TOKENS,
                  interval: float = 0.5) -> dict:
    """Phase 7c: the control plane over phase 7's workers (``--autoscaler
    on --sla-profile``, the profile phase 4s swept), after phase 7b's fleet
    has exited:

    - a ``--qos`` kv frontend (``--record-dir``) adopts the profile from the
      workers' model card (its log line), ``planner.__main__.
      discover_card_profile`` finds the npz's arrays, the standalone router
      service (``python -m dynamo_tpu_torch.router``) and the exporter
      (``python -m dynamo_tpu_torch.metrics_exporter``) come up;
    - router service: ``route`` for request 7 names the worker the
      frontend's router places it on, with the overlap the frontend's router
      counted; ``generate`` streams request 7 with the logprobs of the
      in-process prefix-hit reference, bit for bit (both are hits);
    - exporter: both workers' instance ids, each per-worker gauge equal
      to the worker's own load_metrics, ``fleet_workers_live`` 2;
    - reference passes: the planner leg's completions through the frontend,
      the balancer leg's rows pinned on one worker, from empty caches;
    - planner leg: ``python -m dynamo_tpu_torch.planner --operate
      --profile-from-discovery --balance on`` with a TTFT SLA under the
      profile's TTFT at the leg's prompt lengths and an ITL SLA of 10x its
      ITL at the largest batch; a fresh ``ControlLaw`` first predicts its
      first action (a pool move decode → prefill: the law wants a prefill
      pool); the leg's completions run while the planner moves one worker,
      whose streams relocate to the other. The journal holds the move and
      its ok outcome, the pools moved, each relocated stream equals its
      reference up to its cutover and then by the gap rule
      (``relocated_divergence``), each other one bit for bit;
    - the moved worker back to decode (admin RPC), the balancer leg: the
      rows pinned on one worker, the other idle; the balancer's
      ``migrate_out`` moves one (``balancer_moves_total{outcome="ok"}``),
      the exporter shows the busy worker's active slots above 0, the moved
      stream holds the gap rule, the others bit for bit, the pools and the
      journal unchanged (the scale law held by its cooldown);
    - the planner's decision log replays through a fresh law to the same
      decisions; every process the phase started exits 0; each worker's
      attention launches over the phase equal num_layers x its substeps
      (0 on the CPU)."""
    t_phase = time.perf_counter()
    import tempfile

    from dynamo_tpu_torch.planner.__main__ import operator_config
    from dynamo_tpu_torch.planner.__main__ import parse_args as planner_args
    from dynamo_tpu_torch.planner.core import PlannerObservation
    from dynamo_tpu_torch.planner.interpolate import load_profile
    from dynamo_tpu_torch.planner.operator import ControlLaw, replay_law

    work = tempfile.mkdtemp(prefix="control-phase-")
    record_dir = os.path.join(work, "record")
    decision_log = os.path.join(work, "decisions.jsonl")
    decode, prefill = load_profile(profile_path)
    ttft_sla = 0.5 * min(prefill.ttft_at(n) for n in PLAN_LENS)
    itl_sla = 10.0 * decode.itl_at(decode.batch[-1])
    before = {w.name: settled_counters(w) for w in workers}
    procs: list[Proc] = []
    rcs: dict[str, int] = {}
    try:
        fe = Proc("control-frontend", [
            "dynamo_tpu_torch.frontend", "--store-url", store_url, "--host", "127.0.0.1",
            "--port", "0", "--router-mode", "kv", "--qos", "--record-dir", record_dir])
        exporter = Proc("control-exporter", [
            "dynamo_tpu_torch.metrics_exporter", "--store-url", store_url, "--namespace",
            NAMESPACE, "--host", "127.0.0.1", "--port", "0", "--interval", "0.25"])
        router = Proc("control-router", ["dynamo_tpu_torch.router", "--store-url", store_url,
                                         "--namespace", NAMESPACE, "--block-size", "16"])
        procs += [fe, exporter, router]
        port = int(fe.wait_for(r"frontend: http://127\.0\.0\.1:(\d+)", 120)[0].group(1))
        _, adopted_s = fe.wait_for(r"qos: SLA profile adopted from model card " + re.escape(preset),
                                   120)
        exp_port = int(exporter.wait_for(r"metrics exporter: http://127\.0\.0\.1:(\d+)/metrics",
                                         120)[0].group(1))
        router.wait_for(r"router: dynamo/router routing over backend/generate", 120)
        log(f"control: the --qos frontend adopted the SLA profile from {preset}'s model card "
            f"{adopted_s:.2f}s after launch; router service and exporter up")
        # The law's first action, known before the run: with no prefill
        # engine the law wants one, and the ITL SLA leaves the decode pool
        # a donor.
        pargv = planner_argv(store_url, port, ttft_sla, itl_sla, interval, decision_log)
        cfg = operator_config(planner_args(pargv))
        law = ControlLaw(cfg, decode, prefill)
        predicted = [law.decide(PlannerObservation(empty_window=True), 0, 2, now=0.0)]
        mean_len = statistics.mean(PLAN_LENS)
        for k in (1, 2):
            predicted.append(law.decide(PlannerObservation(ttft_ms=prefill.ttft_at(mean_len)),
                                        0, 2, now=float(k)))
        first = [d for d in predicted[-1] if d.kind != "hold"]
        if [(d.kind, d.src, d.dst) for d in first] != [("pool_move", "decode", "prefill")]:
            raise RuntimeError(f"control: the law's predicted first action is {predicted}")
        log(f"control: SLAs TTFT {ttft_sla:.2f} ms (half the smallest profile TTFT over "
            f"the leg's prompt lengths, {min(PLAN_LENS)}-{max(PLAN_LENS)} tokens), ITL "
            f"{itl_sla:.2f} ms (10x the profile's at B="
            f"{decode.batch[-1]:.0f}); a fresh ControlLaw predicts its first action: "
            f"{first[0].kind} {first[0].src} → {first[0].dst}")
        res = asyncio.run(_drive_control(
            card_line, store_url, port, exp_port, workers, reference, profile_path, preset,
            pargv, plan_tokens, bal_tokens, record_dir, procs, rcs))
        # The decision log replayed through a fresh law.
        with open(decision_log) as f:
            records = [json.loads(line) for line in f]
        replayed = replay_law(ControlLaw(cfg, decode, prefill), records)
        if replayed != [r["decisions"] for r in records]:
            bad = next(i for i, (a, r) in enumerate(zip(replayed, records))
                       if a != r["decisions"])
            raise RuntimeError(f"control: the law replayed cycle {bad} as {replayed[bad]}, "
                               f"the planner decided {records[bad]['decisions']}")
        acted = [(i, d) for i, r in enumerate(records) for d in r["decisions"]
                 if d["kind"] != "hold"]
        if [(d["kind"], d["src"], d["dst"]) for _, d in acted] != [
                ("pool_move", "decode", "prefill")]:
            raise RuntimeError(f"control: the planner's decisions {acted}")
        log(f"control: the decision log's {len(records)} cycles replay through a fresh "
            f"ControlLaw to the same decisions; its one action {acted[0][1]['kind']} "
            f"decode → prefill at cycle {acted[0][0]}")
        for p in (fe, exporter, router):
            rcs[p.name] = p.stop()
        after = {w.name: settled_counters(w) for w in workers}
        launches = {}
        for w in workers:
            b, a = before[w.name], after[w.name]
            d_launch = a["paged_attention_launches"] - b["paged_attention_launches"]
            d_sub = a["decode_substeps"] - b["decode_substeps"]
            want = a["num_layers"] * d_sub if device == "cuda" else 0
            if d_launch != want or d_sub <= 0 or a["eager_windows"] != b["eager_windows"]:
                raise RuntimeError(f"control: {w.name} launched attention {d_launch} times "
                                   f"over {d_sub} substeps of {a['num_layers']} layers, eager "
                                   f"windows {a['eager_windows'] - b['eager_windows']}")
            launches[w.name] = {"launches": d_launch, "substeps": d_sub}
        if any(rcs.values()):
            raise RuntimeError(f"control: processes did not exit 0: {rcs}")
        total = sum(v["launches"] for v in launches.values())
        if device == "cuda" and total <= 0:
            raise RuntimeError("control: no worker launched the kernel")
        res.update(cycles=len(records), launches=total, workers=launches, exit_codes=rcs,
                   ttft_sla_ms=ttft_sla, itl_sla_ms=itl_sla,
                   phase_s=time.perf_counter() - t_phase)
        log(f"control: attention launches {total} over the phase "
            + ", ".join(f"{k} {v['launches']} = layers x {v['substeps']}"
                        for k, v in launches.items())
            + f" (0 on the CPU); every process exited 0 ({rcs}); phase 7c took "
            f"{res['phase_s']:.1f}s ({card_line})")
        return res
    finally:
        for p in procs:
            if p.proc.poll() is None:
                p.kill()
        shutil.rmtree(work, ignore_errors=True)


async def _drive_control(card_line, store_url, port, exp_port, workers, reference,
                         profile_path, preset, pargv, plan_tokens, bal_tokens, record_dir,
                         procs, rcs) -> dict:
    import numpy as np

    from dynamo_tpu_torch.kv_router.router import KvPushRouter, KvRouterConfig
    from dynamo_tpu_torch.llm.migration import Migration
    from dynamo_tpu_torch.llm.model_card import slugify
    from dynamo_tpu_torch.planner.__main__ import discover_card_profile
    from dynamo_tpu_torch.planner.actions import actions_prefix
    from dynamo_tpu_torch.planner.actuate import read_pools
    from dynamo_tpu_torch.planner.interpolate import load_profile
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.engine import Context
    from dynamo_tpu_torch.runtime.push_router import RouterMode

    out: dict = {}
    rt = await DistributedRuntime.create(store_url=store_url)
    try:
        ns = rt.namespace(NAMESPACE)
        # Profile discovery: the card's arrays are the npz's.
        (fd, fp), (wd, wp) = (await discover_card_profile(rt.store, NAMESPACE),
                              load_profile(profile_path))
        for a, b in ((fd.batch, wd.batch), (fd.itl_ms, wd.itl_ms), (fd.tok_s, wd.tok_s),
                     (fp.prompt_len, wp.prompt_len), (fp.ttft_ms, wp.ttft_ms),
                     (fp.tok_s, wp.tok_s)):
            if not np.array_equal(a, b):
                raise RuntimeError("control: the card's discovered profile differs from the npz")
        pools = await read_pools(rt.store, NAMESPACE)
        by_pid = {w.pid: w.instance_id for w in pools["decode"]}
        if len(by_pid) != 2 or pools["prefill"]:
            raise RuntimeError(f"control: pools before the phase {pools}")
        wid = {w.name: by_pid[w.proc.pid] for w in workers}
        gen_ep = ns.component("backend").endpoint("generate")
        push = await gen_ep.router(RouterMode.DIRECT)
        route = await ns.component("router").endpoint("route").router()
        rgen = await ns.component("router").endpoint("generate").router()
        admin = await ns.component("workerctl").endpoint("admin").router(RouterMode.DIRECT)
        for r, n in ((push, 2), (route, 1), (rgen, 1), (admin, 2)):
            await r.discovery.wait_for_instances(n)

        async def frontend_metric(name: str) -> float:
            _, _, pieces, _ = await http_request(port, "/metrics", method="GET")
            text = b"".join(p for _, p in pieces).decode()
            return sum(float(m.group(1)) for m in re.finditer(
                rf"^dynamo_tpu_{name}(?:{{[^}}]*}})? ([0-9.eE+-]+)$", text, re.M))

        async def worker_metrics(name: str) -> str:
            w = next(w for w in workers if w.name == name)
            _, _, pieces, _ = await http_request(w.sys_port, "/metrics", method="GET")
            return b"".join(p for _, p in pieces).decode()

        async def exporter_gauges() -> dict:
            _, _, pieces, _ = await http_request(exp_port, "/metrics", method="GET")
            text = b"".join(p for _, p in pieces).decode()
            return {m.group(1) + m.group(2): float(m.group(3)) for m in re.finditer(
                r"^dynamo_tpu_(fleet_[a-z_]+)(\{[^}]*\}) ([0-9.eE+-]+)$", text, re.M)}

        # -- the router service and the exporter ------------------------------
        prompts = burst_prompts()
        ids7 = list(prompts[7].encode())
        routed7 = [f async for f in route.generate({"token_ids": ids7}, Context())][-1]
        overlap0 = await frontend_metric("router_overlap_blocks_total")
        body7 = {"model": preset, "prompt": prompts[7], "max_tokens": BURST_TOKENS,
                 "temperature": BURST_TEMPS[7], "seed": 1007, "ignore_eos": True, "logprobs": 0}
        fe7 = await http_completion(port, body7, f"{0x7C7:032x}")
        overlap = await frontend_metric("router_overlap_blocks_total") - overlap0
        placed, _ = await routed(port, fe7["trace_id"])
        ref = reference["repeat"]
        if (fe7["status"], fe7.get("logprobs"), fe7.get("lp_tokens")) != (
                200, ref["logprobs"], ref["lp_tokens"]):
            raise RuntimeError(f"control: request 7 through the frontend: {fe7.get('status')}, "
                               "not the prefix-hit reference")
        if (routed7.get("worker_instance_id") != int(placed, 16)
                or routed7.get("overlap_blocks") != overlap or overlap <= 0):
            raise RuntimeError(f"control: route(request 7) answered {routed7}; the frontend "
                               f"placed it on {placed} with overlap {overlap}")
        req7 = {"model": preset, "token_ids": ids7,
                "sampling": {"temperature": BURST_TEMPS[7], "seed": 1007, "logprobs": True},
                "stop": {"max_tokens": BURST_TOKENS, "ignore_eos": True}}
        frames = [f async for f in rgen.generate(req7, Context())]
        lps = [x for f in frames for x in f.get("log_probs") or []]
        ntok = sum(len(f.get("token_ids") or []) for f in frames)
        if ntok != BURST_TOKENS or lps != ref["logprobs"]:
            raise RuntimeError(f"control: the router service's generate streamed {ntok} tokens, "
                               "logprobs not the prefix-hit reference's")
        log(f"control: router service route(request 7) → instance {placed} with "
            f"{overlap:.0f} overlap blocks, as the frontend's router placed and counted it; its "
            f"generate streamed request 7's {ntok} tokens with the prefix-hit reference's "
            f"logprobs bit for bit, as the frontend's repeat did ({card_line})")
        out["route"] = {"instance": placed, "overlap_blocks": overlap}
        for _ in range(100):
            g = await exporter_gauges()
            if g.get(f'fleet_workers_live{{component="backend"}}') == 2 and all(
                    f'fleet_worker_total_slots{{component="backend",worker="{w:x}"}}' in g
                    for w in wid.values()):
                break
            await asyncio.sleep(0.1)
        else:
            raise RuntimeError(f"control: the exporter never listed both workers: {g}")
        # Idle workers: the exporter's gauges are what each worker's own
        # load_metrics reports, and fleet_workers_live counts the workers.
        load = await ns.component("backend").endpoint("load_metrics").router(RouterMode.DIRECT)
        await load.discovery.wait_for_instances(2)
        for _ in range(100):
            want = {}
            for w in wid.values():
                snap = [f async for f in load.generate({}, Context(), instance_id=w)][-1]
                want.update(_exporter_view(w, snap))
            g = await exporter_gauges()
            if {k: g.get(k) for k in want} == want:
                break
            await asyncio.sleep(0.1)
        else:
            raise RuntimeError(f"control: the exporter's gauges {g} are not the workers' own "
                               f"load_metrics {want}")
        if g.get('fleet_workers_live{component="backend"}') != 2:
            raise RuntimeError(f"control: fleet_workers_live {g}")
        log(f"control: exporter lists instances {sorted(f'{w:x}' for w in wid.values())}, "
            f"fleet_workers_live 2, each worker's {len(want) // 2} gauges equal to its own "
            f"load_metrics")

        # -- reference passes ---------------------------------------------------
        plan = plan_prompts()

        def plan_body(i):
            return {"model": preset, "prompt": plan[i], "max_tokens": plan_tokens,
                    "temperature": 0.0, "seed": 3000 + i, "ignore_eos": True, "logprobs": 2}

        async def plan_pass(label: str) -> list[dict]:
            rs = await asyncio.gather(*(http_completion(port, plan_body(i),
                                                        f"{0x7D00 + i:032x}")
                                        for i in range(len(plan))))
            for i, r in enumerate(rs):
                if r["status"] != 200 or (r.get("usage") or {}).get(
                        "completion_tokens") != plan_tokens:
                    raise RuntimeError(f"control {label} request {i}: {r.get('status')} "
                                       f"{r.get('error')} {r.get('usage')}")
            return rs

        bal = balance_requests(preset, bal_tokens)
        rec = LegRecorder(await KvPushRouter(
            push, KvRouterConfig(block_size=16, use_kv_events=False)).start())
        op = Migration(rec, migration_limit=0)

        async def bal_one(i, target, rid):
            r = dict(bal[i], kv_transfer_params={"migration_resume": {"instance": target}})
            got = {"tokens": [], "logprobs": [], "top": [], "finish": None}
            async for item in op.generate(r, Context(rid)):
                if item.get("error"):
                    raise RuntimeError(f"control: balancer leg {rid}: {item['error']}")
                got["tokens"] += item.get("token_ids") or []
                got["logprobs"] += item.get("log_probs") or []
                got["top"] += item.get("top_log_probs") or []
                got["finish"] = item.get("finish_reason") or got["finish"]
            return got

        await clear_kv(port, preset)
        await plan_pass("reference")
        await clear_kv(port, preset)
        busy = workers[0].name
        bal_ref = await asyncio.gather(*(bal_one(i, wid[busy], f"balref-{i}")
                                         for i in range(BAL_ROWS)))
        await clear_kv(port, preset)

        # -- the planner leg ------------------------------------------------------
        # Each worker's migration.out spans (source side) and the KV its
        # migrations received (destination side) before the leg.
        mig0 = {}
        for name in wid:
            text = await worker_metrics(name)
            mig0[name] = (_phase_count(text, "migration.out"),
                          _phase_count(text, "migration.out", "sum"),
                          _metric(text, "dynamo_tpu_migration_kv_bytes_total") or 0.0)
        sys_port = _free_port()
        planner = Proc("control-planner", ["dynamo_tpu_torch.planner", *pargv],
                       env={"DYNTPU_SYSTEM_ENABLED": "1", "DYNTPU_SYSTEM_PORT": str(sys_port)})
        procs.append(planner)
        planner.wait_for(r"card profile discovered \(decode=True prefill=True\)", 120)
        planner.wait_for(r"planner \(closed loop\): watching", 120)
        t_plan = time.perf_counter()
        plan_task = asyncio.ensure_future(plan_pass("planner leg"))
        journal = []
        for _ in range(int(120 / 0.05)):
            journal = [json.loads(e.value) for e in sorted(
                await rt.store.get_prefix(actions_prefix(PLANNER_ID)), key=lambda e: e.key)]
            if any(e["phase"] != "started" for e in journal):
                break
            await asyncio.sleep(0.05)
        t_moved = time.perf_counter() - t_plan
        await plan_task
        plan_wall = time.perf_counter() - t_plan
        pools = await read_pools(rt.store, NAMESPACE)
        if ([(e["kind"], e["phase"], e["src"], e["dst"]) for e in journal]
                != [("pool_move", "ok", "decode", "prefill")]):
            raise RuntimeError(f"control: the journal holds {journal}")
        if len(pools["prefill"]) != 1 or len(pools["decode"]) != 1:
            raise RuntimeError(f"control: pools after the move {pools}")
        moved_iid = pools["prefill"][0].instance_id
        moved = next(n for n, i in wid.items() if i == moved_iid)
        stayed = next(n for n in wid if n != moved)
        psys = await http_request(sys_port, "/metrics", method="GET")
        ptext = b"".join(p for _, p in psys[2]).decode()
        lag = _metric(ptext, "dynamo_tpu_planner_decision_lag_seconds")
        acts = _labelled_pair(ptext, "planner_scale_actions_total")
        if acts != {("pool_move", "ok"): 1.0} or lag is None:
            raise RuntimeError(f"control: planner metrics actions {acts}, lag {lag}")
        streams = recorded_streams(os.path.join(record_dir, f"{slugify(preset)}.jsonl"))
        by_prompt = {}
        for rid, s in streams.items():
            for i, p in enumerate(plan):
                if s["prompt"] == list(p.encode()):
                    by_prompt.setdefault(i, []).append(s)
        if any(len(by_prompt.get(i, ())) != 2 for i in range(len(plan))):
            raise RuntimeError(f"control: recorded streams per prompt "
                               f"{ {i: len(v) for i, v in by_prompt.items()} }")
        relocated, stall, divergence = {}, {}, {}
        for i in range(len(plan)):
            r0, got = by_prompt[i]
            for s in (r0, got):
                if len(s["tokens"]) != plan_tokens or s["finish"] != "length":
                    raise RuntimeError(f"control: planner leg request {i} recorded "
                                       f"{len(s['tokens'])} tokens, {s['finish']}")
            if len(r0["legs"]) != 1:
                raise RuntimeError(f"control: reference request {i} ran {len(r0['legs'])} legs")
            legs = got["legs"]
            if len(legs) == 1:
                _same_streams(f"control: planner leg request {i}", [got], [r0])
                continue
            if len(legs) != 2 or legs[0]["marker"] is None:
                raise RuntimeError(f"control: planner leg request {i} ran {len(legs)} legs")
            cut = len(legs[0]["tokens"])
            relocated[i] = cut
            stall[i] = legs[1]["first"] - legs[0]["last"]
            divergence[i] = relocated_divergence(got, r0, cut, f"control: relocated {i}")
        if not relocated:
            raise RuntimeError("control: the pool move relocated no stream")
        # Every relocated stream one ok migration, none fell back (a balancer
        # move in this leg would be one of them too).
        migs = {w.name: (await asyncio.to_thread(usr1_counters, w)).get("migration") or {}
                for w in workers}
        if (sum(m.get("outcomes", {}).get("ok", 0) for m in migs.values()) != len(relocated)
                or any(m.get("fallback_reasons") for m in migs.values())):
            raise RuntimeError(f"control: the workers' migrations {migs} for {len(relocated)} "
                               "relocated streams")
        # The move's rate: the KV the destination received over the time
        # the source's migrations took (its migration.out spans, begin to
        # commit), not the decision lag, which also holds the scrape and
        # the pool bookkeeping.
        src_text, dest_text = await worker_metrics(moved), await worker_metrics(stayed)
        spans = _phase_count(src_text, "migration.out") - mig0[moved][0]
        mig_s = _phase_count(src_text, "migration.out", "sum") - mig0[moved][1]
        kv_bytes = (_metric(dest_text, "dynamo_tpu_migration_kv_bytes_total") or 0.0
                    ) - mig0[stayed][2]
        if spans != len(relocated) or mig_s <= 0 or kv_bytes <= 0:
            raise RuntimeError(f"control: {moved} recorded {spans:.0f} migration.out spans "
                               f"({mig_s:.3f}s) for {len(relocated)} relocated streams, "
                               f"{stayed} received {kv_bytes:.0f} KV bytes")
        out["planner"] = {"moved": moved, "relocated": relocated, "stall_s": stall,
                          "divergence": divergence, "decision_lag_s": lag,
                          "move_seen_s": t_moved, "wall_s": plan_wall, "kv_bytes": kv_bytes,
                          "migration_s": mig_s, "mb_per_s": kv_bytes / mig_s / 1e6}
        log(f"control: the planner moved {moved} ({moved_iid:x}) decode → prefill, journal "
            f"pool_move ok, pools 1 prefill / 1 decode; decision lag (observation → move done) "
            f"{lag * 1e3:.1f} ms, the move seen {t_moved:.2f}s into the leg; {len(relocated)} "
            f"relocated stream(s) at tokens {relocated}, {kv_bytes / 1e6:.1f} MB of KV to "
            f"{stayed} over {mig_s:.3f}s of migration.out spans, "
            f"{out['planner']['mb_per_s']:.1f} MB/s; client-visible "
            f"stall " + ", ".join(f"{i}: {v * 1e3:.1f} ms" for i, v in stall.items())
            + f"; divergences {divergence} (the gap rule), every other stream bit for bit "
            f"({card_line})")

        # -- the balancer leg -----------------------------------------------------
        back = [f async for f in admin.generate({"cmd": "set_role", "role": "decode"},
                                                Context(), instance_id=moved_iid)]
        for _ in range(600):
            pools = await read_pools(rt.store, NAMESPACE)
            if len(pools["decode"]) == 2 and not pools["prefill"]:
                break
            await asyncio.sleep(0.1)
        else:
            raise RuntimeError(f"control: {moved} back to decode: {back}, pools {pools}")
        await push.discovery.wait_for_instances(2)
        for attempt in range(50):  # the frontend rediscovers the worker's clear_kv
            try:
                await clear_kv(port, preset)
                break
            except RuntimeError:
                if attempt == 49:
                    raise
                await asyncio.sleep(0.2)
        ctext0 = b"".join(p for _, p in (await http_request(
            sys_port, "/metrics", method="GET"))[2]).decode()
        moves0 = _labelled_pair(ctext0, "balancer_moves_total")
        t_bal = time.perf_counter()
        bal_tasks = [asyncio.ensure_future(bal_one(i, wid[busy], f"bal-{i}"))
                     for i in range(BAL_ROWS)]
        busy_gauge = 0.0
        key = f'fleet_worker_active_slots{{component="backend",worker="{wid[busy]:x}"}}'
        while not all(t.done() for t in bal_tasks):
            busy_gauge = max(busy_gauge, (await exporter_gauges()).get(key, 0.0))
            await asyncio.sleep(0.1)
        bal_got = [await t for t in bal_tasks]
        bal_wall = time.perf_counter() - t_bal
        ctext = b"".join(p for _, p in (await http_request(
            sys_port, "/metrics", method="GET"))[2]).decode()
        moves = _labelled_pair(ctext, "balancer_moves_total")
        ok_moves = sum(v for (outcome, _), v in moves.items() if outcome == "ok") - sum(
            v for (outcome, _), v in moves0.items() if outcome == "ok")
        if ok_moves < 1 or busy_gauge <= 0:
            raise RuntimeError(f"control: balancer moves {moves} (before {moves0}), the busy "
                               f"worker's active-slots gauge peaked at {busy_gauge}")
        bal_moved, bal_div = {}, {}
        for i, (got, r0) in enumerate(zip(bal_got, bal_ref)):
            legs = rec.legs[f"bal-{i}"]
            if len(got["tokens"]) != bal_tokens or got["finish"] != "length":
                raise RuntimeError(f"control: balancer leg row {i}: {len(got['tokens'])} tokens")
            if len(legs) == 1:
                _same_streams(f"control: balancer leg row {i}", [got], [r0])
                continue
            bal_moved[i] = legs[0]["tokens"]
            bal_div[i] = relocated_divergence(got, r0, legs[0]["tokens"],
                                              f"control: balanced row {i}")
        journal2 = [json.loads(e.value) for e in
                    await rt.store.get_prefix(actions_prefix(PLANNER_ID))]
        pools = await read_pools(rt.store, NAMESPACE)
        if not bal_moved or len(journal2) != 1 or len(pools["decode"]) != 2:
            raise RuntimeError(f"control: balancer-moved rows {bal_moved}, journal {journal2}, "
                               f"pools {pools}")
        out["balancer"] = {"moves": ok_moves, "moved_rows": bal_moved, "divergence": bal_div,
                           "busy_active_slots_peak": busy_gauge, "wall_s": bal_wall,
                           "stall_s": {i: rec.legs[f"bal-{i}"][1]["first"]
                                       - rec.legs[f"bal-{i}"][0]["last"] for i in bal_moved}}
        log(f"control: the balancer moved row(s) {bal_moved} (cutover token) from {busy} to the "
            f"idle worker ({ok_moves:.0f} migrate_out ok), divergences {bal_div} (the gap rule), "
            f"the others bit for bit; the exporter's active slots of {busy} peaked at "
            f"{busy_gauge:.0f}; pools and journal unchanged ({card_line})")
        rcs[planner.name] = planner.stop()
        return out
    finally:
        await rt.shutdown()
        await rt.store.close()


def _labelled_pair(text: str, name: str) -> dict[tuple[str, str], float]:
    """A counter with two labels (beside any constant ones) of a /metrics
    text → {(first, second) label values, by label name order: value}."""
    out = {}
    for m in re.finditer(rf"^dynamo_tpu_{name}\{{([^}}]*)\}} ([0-9.eE+-]+)$", text, re.M):
        labels = dict(re.findall(r'([a-z_]+)="([^"]*)"', m.group(1)))
        keys = {"planner_scale_actions_total": ("kind", "outcome"),
                "balancer_moves_total": ("outcome", "reason")}[name]
        out[tuple(labels.get(k) for k in keys)] = float(m.group(2))
    return out


def _exporter_view(instance_id: int, snap: dict) -> dict:
    """One worker's load_metrics snapshot → the exporter's per-worker
    gauges it should read as ({series: value})."""
    lbl = f'{{component="backend",worker="{instance_id:x}"}}'
    w, kv = snap["worker"], snap["kv"]
    return {f"fleet_worker_active_slots{lbl}": float(w["request_active_slots"]),
            f"fleet_worker_total_slots{lbl}": float(w["request_total_slots"]),
            f"fleet_worker_waiting{lbl}": float(w["num_requests_waiting"]),
            f"fleet_worker_kv_active_blocks{lbl}": float(kv["kv_active_blocks"]),
            f"fleet_worker_kv_total_blocks{lbl}": float(kv["kv_total_blocks"]),
            f"fleet_worker_kv_usage{lbl}": float(kv["gpu_cache_usage_perc"]),
            f"fleet_worker_prefix_hit_rate{lbl}": float(kv["gpu_prefix_cache_hit_rate"])}


# -- a checkpoint on disk, served int8 through the worker -----------------------

CKPT_REQUESTS = 4  # the burst's first four requests


def _host_f32(tree):
    if isinstance(tree, dict):
        return {k: _host_f32(v) for k, v in tree.items()}
    return tree.numpy() if str(tree.dtype) == "torch.int8" else tree.float().numpy()


def checkpoint_phase(card_line: str, preset: str = "llama-8b", layers: int = 2,
                     device: str = "cuda", dtype: str = "bfloat16", keep: bool = False,
                     vocab_size: int | None = None) -> dict:
    """A checkpoint of ``preset``'s widths with ``layers`` layers (seed 0,
    two safetensors shards, an index and config.json; ``vocab_size`` if
    given) written under build/ (and left there with ``keep`` for phase 9),
    loaded int8 in process (leaves held to quantize_params_np of the
    written arrays) and served by one ``python -m dynamo_tpu_torch.worker
    --model-path <dir> --quant int8 --kv-quant int8 --tokenizer byte``
    behind the store and a kv-mode frontend: 4 aggregate completions, each
    bit-equal (token texts and logprobs) to the in-process engine built
    from the port's ``load_model(<dir>, quant="int8")``."""
    import numpy as np
    import torch

    from dynamo_tpu_torch.engine.loader import load_model
    from dynamo_tpu_torch.engine.quant import quantize_params_np

    procs: list[Proc] = []
    path = None
    try:
        path, name, host, size, write_s = write_checkpoint(preset, layers, device, dtype,
                                                           vocab_size)

        t0 = time.perf_counter()
        lcfg, params = load_model(path, dtype=dtype, quant="int8", device=device)
        load_s = time.perf_counter() - t0
        want = quantize_params_np(_host_f32(host))
        del host
        for k, leaf in _flat(params):
            exp = torch.from_numpy(np.ascontiguousarray(_get(want, k)))
            if leaf.dtype != torch.int8:
                exp = exp.to(leaf.dtype)
            if leaf.dtype != exp.dtype or not torch.equal(leaf.cpu(), exp):
                raise RuntimeError(f"ckpt: loaded leaf {k} differs from quantize_params_np of "
                                   "the written arrays")
        del want
        log(f"ckpt: load_model(quant='int8') in {load_s:.1f}s on {device}; every leaf equals "
            f"quantize_params_np of the written arrays bit for bit ({card_line})")
        ref, ref_counts = asyncio.run(_checkpoint_reference(lcfg, params, name, device, dtype))
        del params
        if device == "cuda":
            torch.cuda.empty_cache()

        store_port = _free_port()
        store_url = f"tcp://127.0.0.1:{store_port}"
        store = Proc("ckpt-store", ["dynamo_tpu_torch.runtime.store_server", "--host",
                                    "127.0.0.1", "--port", str(store_port)])
        procs.append(store)
        store.wait_for(r"store server: tcp://", 60)
        worker = Proc("ckpt-worker", [
            "dynamo_tpu_torch.worker", "--store-url", store_url, "--model-path", path,
            "--quant", "int8", "--kv-quant", "int8", "--tokenizer", "byte", "--dtype", dtype,
            "--device", device, *ENGINE_ARGV])
        procs.append(worker)
        m, _ = worker.wait_for(r"loaded .* \(quant int8\) in ([0-9.]+)s", 600)
        worker_load_s = float(m.group(1))
        _, registered_s = worker.wait_for(r"serving " + re.escape(name), 600)
        log(f"ckpt: worker loaded the checkpoint int8 in {worker_load_s:.1f}s, registered "
            f"{registered_s:.1f}s after launch ({card_line})")
        fe = Proc("ckpt-frontend", ["dynamo_tpu_torch.frontend", "--store-url", store_url,
                                    "--host", "127.0.0.1", "--port", "0", "--router-mode", "kv"])
        procs.append(fe)
        port = int(fe.wait_for(r"frontend: http://127\.0\.0\.1:(\d+)", 120)[0].group(1))
        got = asyncio.run(_checkpoint_http(port, name))
        for i, (r, want_r) in enumerate(zip(got, ref)):
            if r["status"] != 200 or r.get("error") or r["finish"] != "length":
                raise RuntimeError(f"ckpt request {i}: {r['status']} {r.get('error')} "
                                   f"{r.get('finish')!r}")
            if r["logprobs"] != want_r["logprobs"] or r["lp_tokens"] != want_r["lp_tokens"]:
                raise RuntimeError(f"ckpt request {i}: token logprobs differ from the in-process "
                                   "engine's on the same checkpoint")
        rcs = {p.name: p.stop() for p in [fe, worker, store]}
        if any(rcs.values()):
            raise RuntimeError(f"ckpt: processes did not exit 0 on SIGTERM: {rcs}")
        counters = next(json.loads(line) for line in reversed(worker.lines)
                        if line.startswith('{"event": "engine_counters"'))
        got_counts = worker_counts(counters)
        want_counts = _ckpt_counts(lcfg, counters["decode_substeps"], device)
        if got_counts != want_counts:
            raise RuntimeError(f"ckpt: worker launches (attention, int8 kernel, int8 prefill, "
                               f"int8 wide) {got_counts} != {want_counts}")
        wall = max(r["latency_s"] for r in got)
        log(f"ckpt: {CKPT_REQUESTS} aggregate completions through worker --model-path --quant "
            f"int8 --kv-quant int8, each bit-equal to the in-process engine on the same "
            f"checkpoint (token texts and logprobs); worker launches {got_counts} (attention, "
            f"int8 kernel, int8 prefill route, int8 wide entry) for "
            f"{counters['decode_substeps']} substeps; "
            f"in-process {ref_counts}; slowest request {wall:.2f}s ({card_line})")
        return {"name": name, "path": path, "cfg": lcfg, "bytes": size, "write_s": write_s,
                "load_s": load_s,
                "worker_load_s": worker_load_s, "launch_to_registered_s": registered_s,
                "launches": got_counts, "decode_substeps": counters["decode_substeps"],
                "inproc_launches": ref_counts, "latency_s": [r["latency_s"] for r in got]}
    finally:
        for p in procs:
            p.kill()
        if not keep and path is not None:
            shutil.rmtree(path, ignore_errors=True)


def model_source(preset: str, model_path: str | None):
    """(ModelConfig, worker flags naming the weights) of a preset's random
    weights or of a checkpoint, served with the byte tokenizer."""
    from dynamo_tpu_torch.engine.config import ModelConfig
    from dynamo_tpu_torch.engine.loader import load_config

    if model_path:
        return load_config(model_path), ["--model-path", model_path, "--tokenizer", "byte"]
    return ModelConfig.preset(preset), ["--preset", preset]


async def checkpoint_reference(model_path: str, device: str = "cuda", dtype: str = "bfloat16",
                               quant: str = "none", kv_quant: str = "none") -> dict:
    """The burst in process on a checkpoint (``run``'s pipeline with the
    main path's engine arguments, quantized as a worker loads it), then the
    requests of REMOTE again on their cached prefixes → phase 11's
    reference ("burst", "repeats"), as main_path makes it."""
    from dynamo_tpu_torch.llm.protocols import CompletionRequest
    from dynamo_tpu_torch.run.__main__ import build_pipeline, parse_args
    from dynamo_tpu_torch.runtime.engine import Context

    pipe = await build_pipeline(parse_args(
        ["--in", "batch:-", "--model-path", model_path, "--tokenizer", "byte", "--dtype", dtype,
         "--device", device, *ENGINE_ARGV]), quant=quant, kv_quant=kv_quant)
    await asyncio.to_thread(pipe.engine.runner.warm_windows, ("greedy", "simple"))
    prompts = burst_prompts()

    async def one(i):
        req = CompletionRequest.parse({
            "model": pipe.card.name, "prompt": prompts[i], "max_tokens": BURST_TOKENS,
            "temperature": BURST_TEMPS[i], "seed": 1000 + i, "ignore_eos": True, "logprobs": 0})
        gen, t0, ttft = None, time.perf_counter(), None
        async for g, _chunk in pipe.run(req, Context()):
            ttft = ttft if ttft is not None else time.perf_counter() - t0
            gen = g
        return reference_entry(gen, ttft)

    try:
        burst = list(await asyncio.gather(*(one(i) for i in range(8))))
        while pipe.engine.busy():
            await asyncio.sleep(0.001)
        return {"burst": burst, "repeats": {i: await one(i) for i in
                                            sorted(REMOTE, key=lambda i: i != 7)}}
    finally:
        await pipe.engine.stop()


async def local_pipeline(args, quant: str = "none", kv_quant: str = "none", model=None,
                         params=None, start: bool = True, **engine_kw):
    """The run launcher's in-process pipeline (``build_pipeline``), with
    what the phases vary and the launcher has no flag for: ``model`` (a
    ModelConfig, ``cut_config``) in place of ``--preset``'s, ``params``
    (another engine's weights, shared) and further EngineArgs fields
    (adapter slots, host tier) in ``engine_kw``. ``start=False`` leaves
    the engine unstarted (``submit_then_start``)."""
    from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig, spec_engine_args
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer, load_tokenizer, tokenizer_spec_for
    from dynamo_tpu_torch.run.__main__ import LocalPipeline

    tok_spec = tokenizer_spec_for(args.model_path, args.tokenizer)
    if args.model_path:
        from dynamo_tpu_torch.engine.loader import load_model

        model, params = load_model(args.model_path, args.dtype, quant, device=args.device)
    model = model or ModelConfig.preset(args.preset)
    engine = TorchEngine(EngineArgs(
        model=model, block_size=args.block_size, num_kv_blocks=args.num_kv_blocks,
        max_num_seqs=args.max_num_seqs, max_model_len=args.max_model_len, dtype=args.dtype,
        decode_steps=args.decode_steps, device=args.device, quant=quant, kv_quant=kv_quant,
        grammar_tokenizer=tok_spec, **spec_engine_args(args), **engine_kw,
    ), params=params, seed=args.seed)
    if start:
        await engine.start()
    tokenizer = load_tokenizer(tok_spec)
    card = ModelDeploymentCard(
        name=model.name, tokenizer=tok_spec, context_length=args.max_model_len,
        kv_cache_block_size=args.block_size,
        eos_token_ids=list(tokenizer.eos_token_ids) or [ByteTokenizer.EOS])
    return LocalPipeline(card, engine, tokenizer)


async def submit_then_start(engine, coros) -> list:
    """Run ``coros`` (requests through an unstarted engine's pipeline) as
    tasks, wait until the engine holds every one of them, then start it →
    the tasks. Its first admission wave then takes the requests in order
    up to ``admission_budget_tokens``, and so does every later one: the
    waves, and so the decode buckets they fill, do not depend on how fast
    the host submits."""
    tasks = [asyncio.ensure_future(c) for c in coros]
    while engine.metrics().worker.num_requests_waiting < len(tasks):
        done = [t for t in tasks if t.done()]
        if done:
            done[0].result()  # a request that failed before reaching the engine
            raise RuntimeError("a request finished before its engine started")
        await asyncio.sleep(0.001)
    await engine.start()
    return tasks


def cut_config(preset: str, layers: int, vocab_size: int | None = None):
    """``preset``'s widths with ``layers`` layers (and ``vocab_size`` if
    given), named as the checkpoint ``write_checkpoint`` makes of it."""
    import dataclasses

    from dynamo_tpu_torch.engine.config import ModelConfig

    name = f"{preset}-{layers}layers" + (f"-v{vocab_size}" if vocab_size else "")
    return dataclasses.replace(ModelConfig.preset(preset), num_layers=layers, name=name,
                               **({"vocab_size": vocab_size} if vocab_size else {}))


def write_checkpoint(preset: str, layers: int, device: str = "cuda", dtype: str = "bfloat16",
                     vocab_size: int | None = None, root: str | None = None):
    """The random weights of ``cut_config`` (``M.init_params``, seed 0, in
    ``dtype`` on ``device``: the weights an in-process engine of that
    config makes) as an HF checkpoint under <root>/<name> (root
    build/checkpoints by default; two safetensors shards, an index and
    config.json) → (path, name, the written host tree, bytes, seconds)."""
    import torch

    from dynamo_tpu_torch.engine import model as M
    from dynamo_tpu_torch.engine.loader import save_checkpoint

    cfg = cut_config(preset, layers, vocab_size)
    path = os.path.join(root or os.path.join(HERE, "build", "checkpoints"), cfg.name)
    shutil.rmtree(path, ignore_errors=True)
    t0 = time.perf_counter()
    dev_tree = M.init_params(cfg, torch.device(device), getattr(torch, dtype), seed=0)
    host = {k: ({kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict) else v.cpu())
            for k, v in dev_tree.items()}
    del dev_tree
    save_checkpoint(path, cfg, host, shards=2)
    size = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
    write_s = time.perf_counter() - t0
    log(f"ckpt: {cfg.name} written ({size / 1e9:.2f} GB, 2 shards + index + config.json) in "
        f"{write_s:.1f}s")
    return path, cfg.name, host, size, write_s


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _get(tree, key):
    for k in key:
        tree = tree[k]
    return tree


def worker_counts(c: dict) -> tuple[int, int, int, int]:
    """(attention, int8 kernel, int8 prefill route, int8 wide entry) from a
    worker's engine_counters line."""
    return (c["paged_attention_launches"], c["int8_matmul_launches"],
            c["int8_matmul_prefill_launches"], c["int8_matmul_wide_launches"])


def _ckpt_counts(cfg, substeps: int, device: str,
                 lens=tuple(BURST_LENS[:CKPT_REQUESTS])) -> tuple[int, int, int, int]:
    """(attention, int8 kernel, int8 prefill route, int8 wide entry)
    launches of the phase's requests (cold prompts of ``lens`` tokens); all
    0 on the CPU, where the plain versions run."""
    if device != "cuda":
        return 0, 0, 0, 0
    return (cfg.num_layers * substeps, *int8_expected(cfg, lens, substeps))


async def _checkpoint_reference(cfg, params, name, device, dtype):
    """The phase's requests through an in-process engine on the loaded
    weights, with the worker's engine arguments → (reference entries,
    launches as _ckpt_counts counts them)."""
    from dynamo_tpu_torch.engine.config import EngineArgs
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.protocols import CompletionRequest
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
    from dynamo_tpu_torch.run.__main__ import LocalPipeline
    from dynamo_tpu_torch.runtime.engine import Context

    engine = await TorchEngine(EngineArgs(
        model=cfg, block_size=16, num_kv_blocks=2048, max_num_seqs=8, max_model_len=2048,
        decode_steps=8, dtype=dtype, quant="int8", kv_quant="int8", device=device,
    ), params=params).start()
    card = ModelDeploymentCard(name=name, tokenizer={"type": "byte"}, context_length=2048,
                               kv_cache_block_size=16, eos_token_ids=[ByteTokenizer.EOS])
    pipe = LocalPipeline(card, engine, ByteTokenizer())
    await asyncio.to_thread(engine.runner.warm_windows, ("greedy", "simple"))
    zero_counts()
    steps0 = engine.total_decode_steps
    prompts = burst_prompts()

    async def one(i):
        req = CompletionRequest.parse({
            "model": name, "prompt": prompts[i], "max_tokens": BURST_TOKENS,
            "temperature": BURST_TEMPS[i], "seed": 1000 + i, "ignore_eos": True, "logprobs": 0})
        gen = None
        async for g, _chunk in pipe.run(req, Context()):
            gen = g
        return reference_entry(gen, 0.0)

    try:
        refs = await asyncio.gather(*(one(i) for i in range(CKPT_REQUESTS)))
        while engine.busy():
            await asyncio.sleep(0.001)
        counts = int8_counts()
        want = _ckpt_counts(cfg, engine.total_decode_steps - steps0, device)
        if counts != want:
            raise RuntimeError(f"ckpt in process: launches {counts} != {want}")
    finally:
        await engine.stop()
    return refs, counts


async def _checkpoint_http(port: int, model: str) -> list[dict]:
    await _wait_listed(port, model)
    prompts = burst_prompts()
    return await asyncio.gather(*(
        http_completion(port, {"model": model, "prompt": prompts[i], "max_tokens": BURST_TOKENS,
                               "temperature": BURST_TEMPS[i], "seed": 1000 + i,
                               "ignore_eos": True, "logprobs": 0, "stream": False},
                        f"{0xE00 + i:032x}")
        for i in range(CKPT_REQUESTS)))


# -- phase 9: the checkpoint's own tokenizer at full width ----------------------

# Meta-Llama-3.1-8B's pre-tokenizer split and its 256 added specials
# (ids 128000-128255 after 128,000 BPE tokens); EOS as its
# generation_config.json names them.
LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
                r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
LLAMA3_SPECIALS = (["<|begin_of_text|>", "<|end_of_text|>", "<|reserved_special_token_0|>",
                    "<|reserved_special_token_1|>", "<|finetune_right_pad_id|>",
                    "<|reserved_special_token_2|>", "<|start_header_id|>", "<|end_header_id|>",
                    "<|eom_id|>", "<|eot_id|>", "<|python_tag|>"]
                   + [f"<|reserved_special_token_{i}|>" for i in range(3, 248)])
LLAMA3_EOS = ("<|end_of_text|>", "<|eom_id|>", "<|eot_id|>")
TOK_LEARNED_MAX = 20_000  # merges learned from the repository's Markdown at most
TOK_MARGIN_BLOCKS = 16    # KV blocks the worker holds beyond the burst's need
LOOKAHEAD = 24            # tokens a decoding row reserves ahead: K x (depth + 1)


def _llama3_words(texts) -> "collections.Counter":
    """Byte-level words of ``texts`` under the Llama-3 split (the port's
    own pre-tokenizer) → their counts."""
    import collections

    from dynamo_tpu_torch.llm.tokenizer_json import TokenizerJson

    pre = TokenizerJson({"model": {"type": "BPE", "vocab": {}, "merges": []},
                         "pre_tokenizer": _llama3_pre_tokenizer()}).pre_tokenize
    words = collections.Counter()
    for t in texts:
        words.update(w for w, _ in pre([(t, True)]))
    return words


def _llama3_pre_tokenizer() -> dict:
    return {"type": "Sequence", "pretokenizers": [
        {"type": "Split", "pattern": {"Regex": LLAMA3_SPLIT}, "behavior": "Isolated",
         "invert": False},
        {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
         "use_regex": False}]}


def learn_merges(words, limit: int) -> list[tuple[str, str]]:
    """Byte-pair merges learned from word counts, most frequent pair first
    (ties: the smallest pair), until ``limit`` or no pair occurs twice."""
    import collections
    import heapq

    syms = [list(w) for w in words]
    counts = list(words.values())
    pairs: collections.Counter = collections.Counter()
    where = collections.defaultdict(set)
    for i, s in enumerate(syms):
        for q in zip(s, s[1:]):
            pairs[q] += counts[i]
            where[q].add(i)
    heap = [(-c, q) for q, c in pairs.items()]
    heapq.heapify(heap)
    merges: list[tuple[str, str]] = []
    while heap and len(merges) < limit:
        neg, q = heapq.heappop(heap)
        if pairs.get(q, 0) != -neg:
            continue  # a stale entry
        if -neg < 2:
            break
        a, b = q
        merges.append(q)
        touched = set()
        for i in where.pop(q):
            s, c = syms[i], counts[i]
            out, j = [], 0
            while j < len(s):
                if j + 1 < len(s) and s[j] == a and s[j + 1] == b:
                    out.append(a + b)
                    j += 2
                else:
                    out.append(s[j])
                    j += 1
            if len(out) == len(s):
                continue
            for p in zip(s, s[1:]):
                pairs[p] -= c
                touched.add(p)
            for p in zip(out, out[1:]):
                pairs[p] += c
                where[p].add(i)
                touched.add(p)
            syms[i] = out
        for p in touched:
            if pairs[p] > 0:
                heapq.heappush(heap, (-pairs[p], p))
            else:
                pairs.pop(p, None)
    return merges


def write_llama3_tokenizer(path: str, n_bpe: int = 128_000, learned_max: int = TOK_LEARNED_MAX,
                           seed: int = 0) -> dict:
    """A Llama-3.1-shaped tokenizer.json and generation_config.json in
    ``path``: ``n_bpe`` BPE tokens (the 256 byte-level characters, merges
    learned from README.md and SURVEY.md, then merges filled from a seeded
    RNG, each joining two existing tokens, until the vocabulary is full)
    and the 256 specials after them; Split + ByteLevel(use_regex=false),
    ignore_merges, a TemplateProcessing BOS, the ByteLevel decoder."""
    import random

    from dynamo_tpu_torch.llm.tokenizer_json import bytes_to_unicode

    texts = []
    for name in ("README.md", "SURVEY.md"):
        with open(os.path.join(HERE, name), encoding="utf-8") as f:
            texts += [p for p in f.read().split("\n\n") if p.strip()]
    vocab = {ch: i for i, ch in enumerate(bytes_to_unicode()[b] for b in range(256))}
    merges: list[tuple[str, str]] = []
    for a, b in learn_merges(_llama3_words(texts), min(learned_max, n_bpe - 256)):
        merges.append((a, b))
        vocab.setdefault(a + b, len(vocab))
    learned = len(vocab) - 256
    rng = random.Random(seed)
    tokens = list(vocab)
    while len(vocab) < n_bpe:
        a = tokens[rng.randrange(len(tokens))]
        b = tokens[rng.randrange(min(len(tokens), 4096))]
        if a + b in vocab:
            continue
        vocab[a + b] = len(vocab)
        tokens.append(a + b)
        merges.append((a, b))
    bos = LLAMA3_SPECIALS[0]
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": n_bpe + i, "content": t, "single_word": False, "lstrip": False,
                          "rstrip": False, "normalized": False, "special": True}
                         for i, t in enumerate(LLAMA3_SPECIALS)],
        "normalizer": None,
        "pre_tokenizer": _llama3_pre_tokenizer(),
        "post_processor": {"type": "Sequence", "processors": [
            {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": False,
             "use_regex": True},
            {"type": "TemplateProcessing",
             "single": [{"SpecialToken": {"id": bos, "type_id": 0}},
                        {"Sequence": {"id": "A", "type_id": 0}}],
             "pair": [{"SpecialToken": {"id": bos, "type_id": 0}},
                      {"Sequence": {"id": "A", "type_id": 0}},
                      {"SpecialToken": {"id": bos, "type_id": 1}},
                      {"Sequence": {"id": "B", "type_id": 1}}],
             "special_tokens": {bos: {"id": bos, "ids": [n_bpe], "tokens": [bos]}}}]},
        "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                    "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": False, "byte_fallback": False, "ignore_merges": True,
                  "vocab": vocab, "merges": [list(m) for m in merges]},
    }
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    eos = [n_bpe + LLAMA3_SPECIALS.index(t) for t in LLAMA3_EOS]
    with open(os.path.join(path, "generation_config.json"), "w") as f:
        json.dump({"bos_token_id": n_bpe, "eos_token_id": eos}, f)
    return {"ids": n_bpe + len(LLAMA3_SPECIALS), "learned_tokens": learned,
            "merges": len(merges), "eos": eos}


# Phase 9's family sub-check: four published tokenizer kinds at their
# published vocabulary sizes, written from recipes (a fixed corpus and a
# seeded fill, no tokenizers library), loaded by the port and held to
# digests that tests/test_torch_smoke_tokenizer_families.py computes
# through the library on the same recipes.

TOK_FAMILY_SIZES = {"bert": 30_522, "falcon": 65_024, "clip": 49_408, "xlmr": 250_002}
TOK_FAMILY_TEXTS = [
    "Hello, World! The quick brown fox jumps over the lazy dog.",
    "héllo wörld, ça va? naïve café — «quotes» ‘single’ “double”",
    "Ｆｕｌｌｗｉｄｔｈ ｔｅｘｔ ① ② ½ ﬁne ﬂow ㋿ ℌ ²³",
    "日本語のテキストと中文文本，한국어 텍스트도 있습니다。",
    "Привет, как дела? Γειά σου κόσμε! שלום עולם مرحبا بالعالم",
    "emoji 😀🎉👍🏽 👨‍👩‍👧 flags 🇫🇷 and ∑∫√∞ math ±×÷",
    "numbers 1234567 3.14159 2025-10-17 0xDEADBEEF 1,000,000 ٣٤٥ ６７",
    "code: def f(x):\n    return x**2  # comment\n\tif a != b: pass\r\n",
    "Café résumé ñ ä é́ क्षत्रिय",
    "  leading   and   trailing   spaces  　 wide space​ zero",
    "don't won't it's I'm we've they're he'd you'll CAN'T",
    "[CLS] [SEP] [MASK] <s> </s> <unk> <|endoftext|> >>TITLE<<",
    "ΑΣ İstanbul ẞtraße ǅemal ꞵeta İİ",
    "tabs\tand\nnewlines\n\nand\r\nreturns \x00 \x07 � end",
]
TOK_FAMILY_DIGESTS = {  # family → sha256 at TOK_FAMILY_SIZES, through the library
    'bert': 'c0df23d83c97fb88857f0c5410509bfd9477fd2ca73289f220689e5a4f29db17',
    'falcon': 'f387c0102c9dfffd728ec89ebc3ad55f74e8592ce138aa52884433182e1a68a0',
    'clip': 'cd15e6899b49a4a1bce5f4cd04caad5c756345a0bdc43e1a145395dc564fc777',
    'xlmr': '39e3d1e204da5c2d58f8344baa6046c33430e9c8b945004fd94281b4f1397691',
}


def _family_words(spec: dict, texts) -> "collections.Counter":
    """The words of ``texts`` under a tokenizer.json's normalizer and
    pre-tokenizer (the port's) → their counts."""
    import collections

    from dynamo_tpu_torch.llm.tokenizer_json import TokenizerJson

    tj = TokenizerJson({"model": {"type": "BPE", "vocab": {}, "merges": []},
                        "normalizer": spec.get("normalizer"),
                        "pre_tokenizer": spec.get("pre_tokenizer")})
    words = collections.Counter()
    for t in texts:
        t = tj.normalize(t) if tj.normalize else t
        words.update(w for w, _ in tj.pre_tokenize([(t, True)]))
    return words


def _family_corpus() -> list[str]:
    return TOK_FAMILY_TEXTS * 3 + [t.lower() for t in TOK_FAMILY_TEXTS]


def _added(tokens: list[tuple[int, str]]) -> list[dict]:
    return [{"id": i, "content": t, "single_word": False, "lstrip": False, "rstrip": False,
             "normalized": False, "special": True} for i, t in tokens]


def _template(first: list[tuple[str, int]], last: list[tuple[str, int]],
              pair_mid: list[tuple[str, int]]) -> dict:
    """A TemplateProcessing of ``first $A last`` (pair: ``first $A mid $B
    last``)."""
    def special(name, type_id=0):
        return {"SpecialToken": {"id": name, "type_id": type_id}}

    single = [special(n) for n, _ in first] + [{"Sequence": {"id": "A", "type_id": 0}}] \
        + [special(n) for n, _ in last]
    pair = single[:-len(last) or None] + [special(n, 1) for n, _ in pair_mid] \
        + [{"Sequence": {"id": "B", "type_id": 1}}] + [special(n, 1) for n, _ in last]
    names = {n: i for n, i in first + last + pair_mid}
    return {"type": "TemplateProcessing", "single": single, "pair": pair,
            "special_tokens": {n: {"id": n, "ids": [i], "tokens": [n]} for n, i in names.items()}}


def _fill_bpe(vocab: dict, merges: list, n: int, rng, glue=lambda a, b: a + b,
              left_ok=lambda t: True) -> None:
    """Merges of two existing tokens from a seeded RNG until ``vocab`` holds
    ``n`` tokens."""
    tokens = list(vocab)
    while len(vocab) < n:
        a = tokens[rng.randrange(len(tokens))]
        b = tokens[rng.randrange(min(len(tokens), 4096))]
        if not left_ok(a) or glue(a, b) in vocab:
            continue
        vocab[glue(a, b)] = len(vocab)
        tokens.append(glue(a, b))
        merges.append((a, b))


def bert_family(n_ids: int, seed: int = 0) -> dict:
    """bert-base-uncased's components: BertNormalizer (lowercase),
    BertPreTokenizer, WordPiece (``[UNK]``, ``##``), a ``[CLS] $A [SEP]``
    template, the WordPiece decoder; [PAD], [unused0..98], [UNK], [CLS],
    [SEP], [MASK] at ids 0-103."""
    import random

    spec = {"normalizer": {"type": "BertNormalizer", "clean_text": True,
                           "handle_chinese_chars": True, "strip_accents": None,
                           "lowercase": True},
            "pre_tokenizer": {"type": "BertPreTokenizer"}}
    specials = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + ["[UNK]", "[CLS]", "[SEP]",
                                                                  "[MASK]"]
    vocab = {t: i for i, t in enumerate(specials)}
    words = _family_words(spec, _family_corpus())
    for ch in sorted({ch for w in words for ch in w}):
        vocab.setdefault(ch, len(vocab))
        vocab.setdefault("##" + ch, len(vocab))
    for w, _ in sorted(words.items(), key=lambda kv: (-kv[1], kv[0])):
        for k in range(2, len(w)):
            vocab.setdefault(w[:k], len(vocab))
            vocab.setdefault("##" + w[k:], len(vocab))
        vocab.setdefault(w, len(vocab))
    rng = random.Random(seed)
    letters = "abcdefghijklmnopqrstuvwxyz"
    while len(vocab) < n_ids:
        piece = "".join(rng.choice(letters) for _ in range(rng.randint(2, 7)))
        vocab.setdefault(piece if rng.random() < 0.5 else "##" + piece, len(vocab))
    ids = {t: vocab[t] for t in ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")}
    spec.update(
        added_tokens=_added([(i, t) for t, i in ids.items()]),
        post_processor=_template([("[CLS]", ids["[CLS]"])], [("[SEP]", ids["[SEP]"])],
                                 [("[SEP]", ids["[SEP]"])]),
        decoder={"type": "WordPiece", "prefix": "##", "cleanup": True},
        model={"type": "WordPiece", "unk_token": "[UNK]", "continuing_subword_prefix": "##",
               "max_input_chars_per_word": 100, "vocab": vocab})
    return spec


def falcon_family(n_ids: int, seed: int = 0) -> dict:
    """falcon-7b's components: Punctuation, ByteLevel and Digits in one
    Sequence, BPE; its 12 specials (``>>TITLE<<`` … ``<|endoftext|>``) at
    ids 0-11; the ByteLevel decoder."""
    import random

    from dynamo_tpu_torch.llm.tok_common import bytes_to_unicode

    specials = [">>TITLE<<", ">>ABSTRACT<<", ">>INTRODUCTION<<", ">>SUMMARY<<", ">>COMMENT<<",
                ">>ANSWER<<", ">>QUESTION<<", ">>DOMAIN<<", ">>PREFIX<<", ">>SUFFIX<<",
                ">>MIDDLE<<", "<|endoftext|>"]
    spec = {"pre_tokenizer": {"type": "Sequence", "pretokenizers": [
        {"type": "Punctuation", "behavior": "Contiguous"},
        {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
         "use_regex": True},
        {"type": "Digits", "individual_digits": False}]}}
    vocab = {t: i for i, t in enumerate(specials)}
    for b in range(256):
        vocab[bytes_to_unicode()[b]] = len(vocab)
    merges: list[tuple[str, str]] = []
    for a, b in learn_merges(_family_words(spec, _family_corpus()), n_ids // 4):
        merges.append((a, b))
        vocab.setdefault(a + b, len(vocab))
    _fill_bpe(vocab, merges, n_ids, random.Random(seed))
    spec.update(
        added_tokens=_added(list(enumerate(specials))),
        post_processor={"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                        "use_regex": True},
        decoder={"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                 "use_regex": True},
        model={"type": "BPE", "dropout": None, "unk_token": None,
               "continuing_subword_prefix": None, "end_of_word_suffix": None,
               "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
               "vocab": vocab, "merges": [list(m) for m in merges]})
    return spec


CLIP_SPLIT = r"""'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"""


def clip_family(n_ids: int, seed: int = 0) -> dict:
    """clip-vit-base-patch32's components: NFC, Replace(\\s+ → " ") and
    Lowercase; Split (CLIP's pattern, Removed, inverted) then ByteLevel
    without its regex; BPE with ``end_of_word_suffix`` ``</w>``; the
    BPEDecoder; RobertaProcessing with ``<|startoftext|>`` and
    ``<|endoftext|>``, the last two ids."""
    import collections
    import random

    from dynamo_tpu_torch.llm.tok_common import bytes_to_unicode

    spec = {"normalizer": {"type": "Sequence", "normalizers": [
                {"type": "NFC"},
                {"type": "Replace", "pattern": {"Regex": r"\s+"}, "content": " "},
                {"type": "Lowercase"}]},
            "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
                {"type": "Split", "pattern": {"Regex": CLIP_SPLIT}, "behavior": "Removed",
                 "invert": True},
                {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
                 "use_regex": False}]}}
    chars = [bytes_to_unicode()[b] for b in range(256)]
    vocab = {c: i for i, c in enumerate(chars + [c + "</w>" for c in chars])}
    words = _family_words(spec, _family_corpus())
    symbols = {tuple(w[:-1]) + (w[-1] + "</w>",): n for w, n in words.items()}
    merges = []
    for a, b in learn_merges(collections.Counter(symbols), n_ids // 4):
        merges.append((a, b))
        vocab.setdefault(a + b, len(vocab))
    _fill_bpe(vocab, merges, n_ids - 2, random.Random(seed),
              left_ok=lambda t: not t.endswith("</w>"))
    start, end = n_ids - 2, n_ids - 1
    vocab["<|startoftext|>"], vocab["<|endoftext|>"] = start, end
    spec.update(
        added_tokens=_added([(start, "<|startoftext|>"), (end, "<|endoftext|>")]),
        post_processor={"type": "RobertaProcessing", "sep": ["<|endoftext|>", end],
                        "cls": ["<|startoftext|>", start], "trim_offsets": False,
                        "add_prefix_space": False},
        decoder={"type": "BPEDecoder", "suffix": "</w>"},
        model={"type": "BPE", "dropout": None, "unk_token": "<|endoftext|>",
               "continuing_subword_prefix": "", "end_of_word_suffix": "</w>",
               "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
               "vocab": vocab, "merges": [list(m) for m in merges]})
    return spec


def darts_charsmap(mapping: dict[str, str]) -> bytes:
    """A SentencePiece ``precompiled_charsmap`` for ``mapping`` (key →
    replacement): a little-endian u32 byte count, a darts-clone double
    array over the keys' UTF-8 bytes (each node's children at its base XOR
    their byte, a key's end a leaf at its base XOR 0 whose value is the
    replacement's offset), then the pool of NUL-terminated replacements."""
    import struct

    pool = bytearray()
    at: dict[str, int] = {}
    for value in sorted(set(mapping.values())):
        at[value] = len(pool)
        pool += value.encode("utf-8") + b"\0"
    trie: dict = {}
    for key, value in mapping.items():
        node = trie
        for b in key.encode("utf-8"):
            node = node.setdefault(b, {})
        node[None] = at[value]
    units = [0] * 4096
    used = bytearray(4096)  # positions holding a unit
    bases: set[int] = set()  # no two nodes share a base
    used[0] = 1
    top = 0
    stack = [(0, trie)]
    while stack:
        pos, node = stack.pop()
        labels = sorted(0 if k is None else k for k in node)
        q = used.find(0, 1)
        while True:
            if q < 0 or q + 512 > len(used):
                units.extend([0] * len(units))
                used.extend(bytes(len(used)))
                q = used.find(0, 1) if q < 0 else q
                continue
            base = q ^ labels[0]
            if (base not in bases and (pos ^ base) < 1 << 21
                    and not any(used[base ^ c] for c in labels)):
                break
            q = used.find(0, q + 1)
        bases.add(base)
        units[pos] |= (pos ^ base) << 10 | (1 << 8 if None in node else 0)
        for c in labels:
            used[base ^ c] = 1
        top = max(top, base | 0xFF)
        if None in node:
            units[base] = node[None] | 1 << 31
        for c in labels:
            if c:
                units[base ^ c] = c
                stack.append((base ^ c, node[c]))
    n = top + 1  # every block a lookup may touch lies inside the array
    return struct.pack("<I", 4 * n) + struct.pack(f"<{n}I", *units[:n]) + bytes(pool)


def xlmr_charsmap() -> bytes:
    """A charsmap of the kind SentencePiece precompiles: NFKC of each
    Basic Multilingual Plane character it changes, some whitespace and
    zero-width characters, and a few decomposed clusters mapped whole."""
    import unicodedata

    mapping = {}
    for c in range(0x20, 0x10000):
        ch = chr(c)
        if 0xD800 <= c < 0xE000:
            continue
        norm = unicodedata.normalize("NFKC", ch)
        if norm != ch:
            mapping[ch] = norm
    mapping.update({"​": "", " ": " ", "\t": " ", "\n": " ", "　": " ",
                    "é": "é", "ä": "ä", "ñ": "ñ", "\r\n": " "})
    return darts_charsmap(mapping)


def xlmr_family(n_ids: int, seed: int = 0) -> dict:
    """xlm-roberta-base / t5-small's components: Precompiled (a charsmap
    of ``xlmr_charsmap``) then Replace(" {2,}" → " "); WhitespaceSplit then
    Metaspace; Unigram with ``<unk>`` (id 3); a ``<s> $A </s>`` template;
    the Metaspace decoder; ``<mask>`` the last id."""
    import base64
    import math
    import random

    spec = {"normalizer": {"type": "Sequence", "normalizers": [
                {"type": "Precompiled",
                 "precompiled_charsmap": base64.b64encode(xlmr_charsmap()).decode()},
                {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "}]},
            "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
                {"type": "WhitespaceSplit"},
                {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always",
                 "split": True}]}}
    pieces = {"<s>": 0.0, "<pad>": 0.0, "</s>": 0.0, "<unk>": 0.0}
    words = _family_words(spec, _family_corpus())
    counts: dict[str, int] = {}
    for w, n in words.items():
        for i in range(len(w)):
            for j in range(i + 1, min(len(w), i + 8) + 1):
                counts[w[i:j]] = counts.get(w[i:j], 0) + n
    total = sum(counts.values())
    for p, n in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0])):
        if len(pieces) >= n_ids - 1:
            break
        pieces.setdefault(p, math.log(n / total) - 0.1 * len(p))
    rng = random.Random(seed)
    alphabet = "abcdefghijklmnopqrstuvwxyzабвгдежзийклмнопрстуфхцчшщыэюя"
    score = min(pieces.values()) - 1.0
    while len(pieces) < n_ids - 1:
        p = "".join(rng.choice(alphabet) for _ in range(rng.randint(2, 8)))
        p = "▁" + p if rng.random() < 0.4 else p
        if p not in pieces:
            pieces[p] = score
            score -= 1e-4
    pieces["<mask>"] = 0.0
    vocab = [[p, s] for p, s in pieces.items()]
    ids = {p: i for i, (p, _) in enumerate(vocab)}
    spec.update(
        added_tokens=_added([(ids[t], t) for t in ("<s>", "<pad>", "</s>", "<unk>", "<mask>")]),
        post_processor=_template([("<s>", 0)], [("</s>", 2)], [("</s>", 2), ("</s>", 2)]),
        decoder={"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always",
                 "split": True},
        model={"type": "Unigram", "unk_id": 3, "vocab": vocab, "byte_fallback": False})
    return spec


TOK_FAMILIES = {"bert": bert_family, "falcon": falcon_family, "clip": clip_family,
                "xlmr": xlmr_family}


def write_family_tokenizer(family: str, path: str, n_ids: int | None = None) -> str:
    """``family``'s tokenizer.json (at its published size unless ``n_ids``)
    in the directory ``path`` → path."""
    spec = {"version": "1.0", "truncation": None, "padding": None, "added_tokens": [],
            "normalizer": None, "pre_tokenizer": None, "post_processor": None, "decoder": None}
    spec.update(TOK_FAMILIES[family](n_ids or TOK_FAMILY_SIZES[family]))
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    return path


def family_outputs(tok, stream_cls, texts=TOK_FAMILY_TEXTS) -> dict:
    """What a tokenizer makes of ``texts``: ids, decodes with and without
    specials, and ``DecodeStream`` deltas (``stream_cls`` is either
    package's class)."""
    ids = [tok.encode(t) for t in texts]
    out = {"ids": ids, "vocab_size": tok.vocab_size, "eos": tok.eos_token_ids,
           "decoded": [tok.decode(i) for i in ids],
           "raw": [tok.decode(i, skip_special_tokens=False) for i in ids], "stream": []}
    for i in ids:
        ds = stream_cls(tok)
        out["stream"].append([ds.step(t) for t in i] + [ds.flush()])
    return out


def family_digest(outputs: dict) -> str:
    import hashlib

    return hashlib.sha256(json.dumps(outputs, ensure_ascii=False,
                                     sort_keys=True).encode("utf-8")).hexdigest()


def tok_family_check(card_line: str, root: str, sizes: dict | None = None,
                     digests: dict | None = None) -> dict:
    """Each family written under ``root`` (at ``sizes``, by default the
    published ones), loaded by the port's ``load_tokenizer``, its outputs
    on TOK_FAMILY_TEXTS hashed and held to ``digests`` (by default
    TOK_FAMILY_DIGESTS when the sizes are the published ones); load
    seconds, encode and DecodeStream µs per token."""
    from dynamo_tpu_torch.llm.tokenizer import DecodeStream, load_tokenizer

    sizes = sizes or TOK_FAMILY_SIZES
    if digests is None and sizes == TOK_FAMILY_SIZES:
        digests = TOK_FAMILY_DIGESTS
    out = {}
    try:
        for fam, n in sizes.items():
            t0 = time.perf_counter()
            path = write_family_tokenizer(fam, os.path.join(root, fam), n)
            write_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            tok = load_tokenizer({"type": "hf", "path": path})
            load_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            ids = [tok.encode(t) for t in TOK_FAMILY_TEXTS]
            encode_s = time.perf_counter() - t0
            n_tok = sum(len(i) for i in ids)
            t0 = time.perf_counter()
            for i in ids:
                ds = DecodeStream(tok)
                for t in i:
                    ds.step(t)
                ds.flush()
            stream_s = time.perf_counter() - t0
            outputs = family_outputs(tok, DecodeStream)
            digest = family_digest(outputs)
            if tok.vocab_size != n:
                raise RuntimeError(f"tok family {fam}: {tok.vocab_size} ids, not {n}")
            if digests is not None and digests.get(fam) != digest:
                raise RuntimeError(f"tok family {fam}: digest {digest} != the library's "
                                   f"{digests.get(fam)}")
            out[fam] = {"ids": n, "digest": digest, "write_s": write_s, "load_s": load_s,
                        "tokens": n_tok, "encode_us_per_token": encode_s / n_tok * 1e6,
                        "decode_stream_us_per_token": stream_s / n_tok * 1e6}
            log(f"tok family {fam}: {n} ids written in {write_s:.3f}s, loaded by the port in "
                f"{load_s:.3f}s; encode {encode_s / n_tok * 1e6:.2f} us/token, DecodeStream "
                f"{stream_s / n_tok * 1e6:.2f} us/token over {n_tok} tokens; digest "
                f"{digest[:16]} {'equal to the library' if digests else '(no reference)'} "
                f"(host CPU beside {card_line})")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def readme_cuts() -> list[str]:
    """The burst's lengths cut from README.md one after another (distinct
    prefixes, so no request hits another's cached blocks)."""
    with open(os.path.join(HERE, "README.md"), encoding="utf-8") as f:
        text = f.read()
    out, at = [], 0
    for n in BURST_LENS:
        out.append(text[at:at + n])
        at += n
    return out


def tok_bodies(model: str) -> list[dict]:
    """Phase 9's requests: even ones chat, odd ones completions, the
    burst's temperatures and seeds, 64 tokens, logprobs, aggregated."""
    out = []
    for i, prompt in enumerate(readme_cuts()):
        body = {"model": model, "max_tokens": BURST_TOKENS, "temperature": BURST_TEMPS[i],
                "seed": 1000 + i, "ignore_eos": True, "stream": False}
        if i % 2 == 0:
            body.update(messages=[{"role": "user", "content": prompt}], logprobs=True)
        else:
            body.update(prompt=prompt, logprobs=0)
        out.append(body)
    return out


def tok_prompt_tokens(card, tokenizer, bodies) -> list[int]:
    """Each body's prompt tokens as the port's preprocessor makes them (chat:
    the rendered template)."""
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.protocols import ChatCompletionRequest, CompletionRequest

    pre = OpenAIPreprocessor(card, tokenizer)
    out = []
    for b in bodies:
        if "messages" in b:
            out.append(len(pre.preprocess_chat(ChatCompletionRequest.parse(b)).token_ids))
        else:
            out.append(len(pre.preprocess_completion(CompletionRequest.parse(b)).token_ids))
    return out


def tok_geometry(prompt_tokens: list[int], batch_prompt_tokens: list[int],
                 max_model_len: int = 2048, bs: int = 16) -> dict:
    """The worker's KV blocks and the mixed-priority check's batch lengths:
    the burst fits with TOK_MARGIN_BLOCKS to spare (no preemption there),
    and the two batch requests together need more blocks than the pool
    holds, each within max_model_len, so running both forces a
    preemption."""
    need = sum(-(-(n + BURST_TOKENS + LOOKAHEAD) // bs) for n in prompt_tokens)
    blocks = need + TOK_MARGIN_BLOCKS + 1  # block 0 is the sink
    per_batch = -(-((blocks - 1) * bs * 11) // 20)  # 55% of the pool each
    if per_batch > max_model_len - 8:
        raise RuntimeError(f"tok: the burst needs {need} blocks; two batch requests of "
                           f"{per_batch} tokens would not fit max_model_len {max_model_len}")
    gens = [per_batch - n for n in batch_prompt_tokens]
    if min(gens) < BURST_TOKENS:
        raise RuntimeError(f"tok: batch prompts of {batch_prompt_tokens} tokens leave "
                           f"{gens} to generate")
    return {"num_kv_blocks": blocks, "burst_blocks": need, "batch_max_tokens": gens}


def tok_mixed_prompts() -> tuple[list[str], str]:
    """The mixed-priority check's two batch prompts (README's first 5,000
    characters, halved) and its interactive one (a short cut from README's
    end, so that it decodes within one 128-position attention chunk)."""
    with open(os.path.join(HERE, "README.md"), encoding="utf-8") as f:
        text = f.read()
    return [text[:2500], text[2500:5000]], text[-170:-20]


def tokenizer_phase(card_line: str, path: str, cfg, device: str = "cuda",
                    dtype: str = "bfloat16") -> dict:
    """Phase 9: a Llama-3.1-shaped tokenizer written into the phase-8
    checkpoint ``path``, served by ``worker --model-path --quant int8
    --kv-quant int8`` with no --tokenizer behind the store and a kv-mode
    frontend; 4 chat and 4 completion requests bit-equal to an in-process
    engine on the loaded weights fed the port tokenizer's ids, the launches
    held, one mixed-priority check with a preemption, and the tokenizer's
    host numbers. First, in process, the family sub-check
    (``tok_family_check``): the bert, falcon, clip and xlmr kinds at their
    published sizes held to the library's digests."""

    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.tokenizer import DecodeStream, HFTokenizer, load_tokenizer

    name = os.path.basename(path)
    procs: list[Proc] = []
    try:
        t0 = time.perf_counter()
        families = tok_family_check(card_line, os.path.join(os.path.dirname(path), "tok_families"))
        families_s = time.perf_counter() - t0
        log(f"tok: families {sorted(families)} equal to the library's digests in "
            f"{families_s:.1f}s (host CPU beside {card_line})")
        t0 = time.perf_counter()
        wrote = write_llama3_tokenizer(path, cfg.vocab_size - len(LLAMA3_SPECIALS))
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tok = load_tokenizer({"type": "hf", "path": path})
        load_s = time.perf_counter() - t0
        bos = wrote["ids"] - len(LLAMA3_SPECIALS)
        if (tok.vocab_size != cfg.vocab_size or tok.eos_token_ids != wrote["eos"]
                or tok.encode("<|begin_of_text|>") != [bos, bos]):
            raise RuntimeError(f"tok: the written tokenizer reads back wrong: vocab "
                               f"{tok.vocab_size}, eos {tok.eos_token_ids}")
        log(f"tok: tokenizer.json written ({wrote['ids']} ids, {wrote['learned_tokens']} "
            f"tokens learned from README.md and SURVEY.md, {wrote['merges']} merges) in "
            f"{write_s:.1f}s; loaded in process in {load_s:.3f}s (host CPU beside {card_line})")

        # Host numbers: encode over the 8 prompts on a fresh tokenizer (its
        # BPE cache cold), then again (warm).
        prompts = readme_cuts()
        fresh = HFTokenizer(path)
        t0 = time.perf_counter()
        enc = [fresh.encode(p) for p in prompts]
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for p in prompts:
            fresh.encode(p)
        warm_s = time.perf_counter() - t0
        n_tok = sum(len(e) for e in enc)
        chars = sum(len(p) for p in prompts)

        bodies = tok_bodies(name)
        card = ModelDeploymentCard(name=name, tokenizer={"type": "hf", "path": path},
                                   context_length=2048, kv_cache_block_size=16,
                                   eos_token_ids=tok.eos_token_ids)
        prompt_tokens = tok_prompt_tokens(card, tok, bodies)
        if any(prompt_tokens[i] != len(enc[i]) for i in range(1, len(bodies), 2)):
            raise RuntimeError("tok: a completion's prompt tokens differ from encode()")
        batch_prompts, inter_prompt = tok_mixed_prompts()
        geo = tok_geometry(prompt_tokens, [len(tok.encode(p)) for p in batch_prompts])
        engine_argv = ["--block-size", "16", "--num-kv-blocks", str(geo["num_kv_blocks"]),
                       "--max-num-seqs", "8", "--max-model-len", "2048", "--decode-steps", "8",
                       "--seed", "0"]
        ref, ref_counts, lp_ids = asyncio.run(_tok_reference(
            cfg, path, card, tok, bodies, prompt_tokens, geo["num_kv_blocks"], device, dtype))
        t0 = time.perf_counter()
        for ids in lp_ids:
            ds = DecodeStream(tok)
            for t in ids:
                ds.step(t)
            ds.flush()
        decode_us = (time.perf_counter() - t0) / sum(len(i) for i in lp_ids) * 1e6
        if device == "cuda":
            import torch

            torch.cuda.empty_cache()

        store_port = _free_port()
        store_url = f"tcp://127.0.0.1:{store_port}"
        store = Proc("tok-store", ["dynamo_tpu_torch.runtime.store_server", "--host",
                                   "127.0.0.1", "--port", str(store_port)])
        procs.append(store)
        store.wait_for(r"store server: tcp://", 60)
        sys_port = _free_port()
        worker = Proc("tok-worker", [
            "dynamo_tpu_torch.worker", "--store-url", store_url, "--model-path", path,
            "--quant", "int8", "--kv-quant", "int8", "--dtype", dtype, "--device", device,
            *engine_argv], env={"DYNTPU_SYSTEM_ENABLED": "1", "DYNTPU_SYSTEM_PORT": str(sys_port)})
        procs.append(worker)
        _, registered_s = worker.wait_for(r"serving " + re.escape(name), 600)
        fe = Proc("tok-frontend", ["dynamo_tpu_torch.frontend", "--store-url", store_url,
                                   "--host", "127.0.0.1", "--port", "0", "--router-mode", "kv"])
        procs.append(fe)
        port = int(fe.wait_for(r"frontend: http://127\.0\.0\.1:(\d+)", 120)[0].group(1))
        got = asyncio.run(_tok_http(port, name, bodies))
        fe_load = next((float(m.group(1)) for m in (
            re.search(r"tokenizer hf:\S+ loaded in ([0-9.]+)s", line) for line in fe.lines) if m),
            None)
        if fe_load is None:
            raise RuntimeError("tok: the frontend logged no tokenizer load")
        for i, (r, want) in enumerate(zip(got, ref)):
            if r["status"] != 200 or r.get("error") or r["finish"] != "length":
                raise RuntimeError(f"tok request {i}: {r['status']} {r.get('error')} "
                                   f"{r.get('finish')!r}")
            if (r["logprobs"] != want["logprobs"] or r["lp_tokens"] != want["lp_tokens"]
                    or r["text"] != want["text"]):
                raise RuntimeError(f"tok request {i}: token texts or logprobs differ from the "
                                   "in-process engine's on the same checkpoint and tokenizer")
            if r["usage"]["prompt_tokens"] != prompt_tokens[i]:
                raise RuntimeError(f"tok request {i}: usage.prompt_tokens "
                                   f"{r['usage']['prompt_tokens']} != {prompt_tokens[i]}")
        counters = settled_counters(worker)
        got_counts = worker_counts(counters)
        want_counts = _ckpt_counts(cfg, counters["decode_substeps"], device, prompt_tokens)
        if got_counts != want_counts:
            raise RuntimeError(f"tok: worker launches (attention, int8 kernel, int8 prefill, "
                               f"int8 wide) {got_counts} != {want_counts}")
        mixed = asyncio.run(_tok_mixed(port, sys_port, name, batch_prompts, inter_prompt,
                                       geo["batch_max_tokens"]))
        rcs = {p.name: p.stop() for p in [fe, worker, store]}
        if any(rcs.values()):
            raise RuntimeError(f"tok: processes did not exit 0 on SIGTERM: {rcs}")
        final = next(json.loads(line) for line in reversed(worker.lines)
                     if line.startswith('{"event": "engine_counters"'))
        if final["paged_attention_launches"] != (
                cfg.num_layers * final["decode_substeps"] if device == "cuda" else 0):
            raise RuntimeError(f"tok: worker attention launches {final} != layers x substeps")
        log(f"tok: {len(bodies)} aggregate requests (4 chat, 4 completions) through worker "
            f"--model-path --quant int8 --kv-quant int8 with no --tokenizer, each bit-equal to "
            f"the in-process engine on the port tokenizer's ids (token texts and logprobs), "
            f"prompt tokens {prompt_tokens}; worker launches {got_counts} (attention, int8 "
            f"kernel, int8 prefill route, int8 wide entry) for {counters['decode_substeps']} "
            f"substeps; "
            f"in-process {ref_counts}; mixed priority: {mixed['preempted_batch']} batch "
            f"preemption(s), the interactive stream equal to its solo run ({card_line})")
        log(f"tok: host CPU beside {card_line}: tokenizer load {fe_load:.3f}s in the frontend, "
            f"{load_s:.3f}s in process; encode {cold_s / n_tok * 1e6:.2f} us/token cold, "
            f"{warm_s / n_tok * 1e6:.2f} warm, {chars / n_tok:.3f} chars/token over the "
            f"{len(prompts)} prompts ({n_tok} tokens); DecodeStream {decode_us:.2f} us/token "
            f"over {sum(len(i) for i in lp_ids)} tokens; worker registered {registered_s:.1f}s "
            f"after launch")
        return {"families": families, "families_s": families_s,
                "name": name, "ids": wrote["ids"], "learned_tokens": wrote["learned_tokens"],
                "merges": wrote["merges"], "write_s": write_s, "load_s_inproc": load_s,
                "load_s_frontend": fe_load, "encode_us_per_token_cold": cold_s / n_tok * 1e6,
                "encode_us_per_token_warm": warm_s / n_tok * 1e6, "chars_per_token": chars / n_tok,
                "decode_stream_us_per_token": decode_us, "prompt_tokens": prompt_tokens,
                "launch_to_registered_s": registered_s, "num_kv_blocks": geo["num_kv_blocks"],
                "launches": got_counts, "decode_substeps": counters["decode_substeps"],
                "inproc_launches": ref_counts, "mixed": mixed,
                "latency_s": [r["latency_s"] for r in got]}
    finally:
        for p in procs:
            p.kill()
        shutil.rmtree(path, ignore_errors=True)


async def _tok_reference(cfg, path, card, tok, bodies, prompt_tokens, num_kv_blocks, device,
                         dtype):
    """Phase 9's requests through an in-process engine on the loaded
    weights with the worker's engine arguments → (choice views, launches,
    generated token ids)."""
    from dynamo_tpu_torch.engine.config import EngineArgs
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.loader import load_model
    from dynamo_tpu_torch.llm.protocols import ChatCompletionRequest, CompletionRequest
    from dynamo_tpu_torch.run.__main__ import LocalPipeline
    from dynamo_tpu_torch.runtime.engine import Context

    _, params = await asyncio.to_thread(load_model, path, dtype, "int8", device)
    engine = await TorchEngine(EngineArgs(
        model=cfg, block_size=16, num_kv_blocks=num_kv_blocks, max_num_seqs=8,
        max_model_len=2048, decode_steps=8, dtype=dtype, quant="int8", kv_quant="int8",
        device=device), params=params).start()
    del params
    pipe = LocalPipeline(card, engine, tok)
    await asyncio.to_thread(engine.runner.warm_windows, ("greedy", "simple"))
    zero_counts()
    steps0 = engine.total_decode_steps

    async def one(body):
        chat = "messages" in body
        req = (ChatCompletionRequest if chat else CompletionRequest).parse(body)
        gen = None
        async for g, _chunk in pipe.run(req, Context()):
            gen = g
        view = choice_view("chat" if chat else "completion", gen.final_response()["choices"][0])
        return view, list(gen.lp_tokens)

    try:
        out = await asyncio.gather(*(one(b) for b in bodies))
        while engine.busy():
            await asyncio.sleep(0.001)
        counts = int8_counts()
        want = _ckpt_counts(cfg, engine.total_decode_steps - steps0, device, prompt_tokens)
        if counts != want:
            raise RuntimeError(f"tok in process: launches {counts} != {want}")
    finally:
        await engine.stop()
    return [v for v, _ in out], counts, [ids for _, ids in out]


async def _wait_listed(port: int, model: str) -> None:
    for _ in range(600):
        _, _, pieces, _ = await http_request(port, "/v1/models", method="GET")
        if [m["id"] for m in json.loads(b"".join(p for _, p in pieces))["data"]] == [model]:
            return
        await asyncio.sleep(0.1)
    raise RuntimeError(f"the frontend never listed {model}")


async def _tok_http(port: int, model: str, bodies: list[dict]) -> list[dict]:
    await _wait_listed(port, model)
    return await asyncio.gather(*(http_completion(port, b, f"{0xF00 + i:032x}")
                                  for i, b in enumerate(bodies)))


async def _preemptions(sys_port: int) -> dict[str, float]:
    _, _, pieces, _ = await http_request(sys_port, "/metrics", method="GET")
    text = b"".join(p for _, p in pieces).decode()
    return {m.group(1): float(m.group(2)) for m in re.finditer(
        r'^dynamo_tpu_engine_preemptions_total\{class="(\w+)"\} ([0-9.eE+-]+)$', text, re.M)}


async def _tok_mixed(port: int, sys_port: int, model: str, batch_prompts: list[str],
                     inter_prompt: str, batch_max_tokens: list[int]) -> dict:
    """Two batch requests whose KV outgrows the pool, then an interactive
    one: a batch sequence is preempted (engine_preemptions_total{class=
    "batch"} rises, the interactive class's does not), and the interactive
    response equals its solo run, both cold (token texts and logprobs)."""
    def inter(tag):
        return http_completion(port, {
            "model": model, "prompt": inter_prompt, "max_tokens": BURST_TOKENS,
            "temperature": 0.0, "seed": 7, "ignore_eos": True, "logprobs": 0,
            "priority": "interactive"}, tag)

    solo = await inter(f"{0xF10:032x}")
    await clear_kv(port, model, workers=1)
    before = await _preemptions(sys_port)
    batch = [asyncio.ensure_future(http_completion(port, {
        "model": model, "prompt": p, "max_tokens": n, "temperature": 0.0, "seed": 8 + i,
        "ignore_eos": True, "priority": "batch"}, f"{0xF20 + i:032x}"))
        for i, (p, n) in enumerate(zip(batch_prompts, batch_max_tokens))]
    await asyncio.sleep(0.5)  # both batch requests admitted
    mixed = await inter(f"{0xF30:032x}")
    done = await asyncio.gather(*batch)
    after = await _preemptions(sys_port)
    rose = after.get("batch", 0.0) - before.get("batch", 0.0)
    for r, n in zip(done, batch_max_tokens):
        if r["status"] != 200 or r["usage"]["completion_tokens"] != n:
            raise RuntimeError(f"tok mixed: a batch request ended {r['status']} {r.get('usage')}")
    if rose < 1 or after.get("interactive", 0.0) != before.get("interactive", 0.0):
        raise RuntimeError(f"tok mixed: preemptions by class {before} → {after}")
    for r in (solo, mixed):
        if r["status"] != 200 or r["finish"] != "length":
            raise RuntimeError(f"tok mixed: interactive {r['status']} {r.get('error')}")
    if (mixed["logprobs"], mixed["lp_tokens"]) != (solo["logprobs"], solo["lp_tokens"]):
        raise RuntimeError("tok mixed: the interactive stream differs from its solo run")
    return {"preempted_batch": rose, "batch_max_tokens": batch_max_tokens,
            "interactive_latency_s": mixed["latency_s"], "solo_latency_s": solo["latency_s"]}


# -- phase 10: speculative decoding at full width ------------------------------

SPEC_TOKENS = 3
SPEC_TREE = dict(spec_tree_width=2, spec_tree_depth=3)
# Random weights repeat single tokens long before they repeat trigrams, so
# every run of the phase drafts from 1-gram contexts (the flag's default, 3,
# left the int8 model's 64-token streams without a single draft).
SPEC_NGRAM = 1
# A fused or tree verify pass computes a greedy row's logits in other
# products than the dense substep (B·S1 rows against 8, the multi-query
# attention against the decode one), so in bf16 its logits differ from the
# dense run's by rounding. Its greedy stream may therefore leave the dense
# stream only at a position where the dense run's two most likely tokens
# are within this many nats of each other; past that point the two streams
# continue different texts and are not compared. Stepwise passes run the
# dense substep itself and must match bit for bit.
SPEC_GAP_TOL = 0.25


PACKED_ROWS = 4  # prefill_batch_max of phase 10's packed-prefill pass


async def packed_prefill_pass(engine, burst, against_dense, dense, singles: dict, tag: str,
                              card_line: str) -> dict:
    """Phase 10's dense burst again with ``prefill_batch_max`` PACKED_ROWS
    and the tail split off, so that the burst's prompts of 768 and 1,024
    tokens share the 1,024 rung and those of 1,280 and 1,536 the 2,048 one:
    each pair prefills as one packed dispatch of two rows. Its greedy
    streams must equal the singles pass's (``dense``, whose numbers are
    ``singles``) under the gap rule (``against_dense``); nothing runs
    eagerly (``burst`` checks). → the burst's numbers, the packed
    dispatches (rows, T, W) and the gap rule's."""
    runner = engine.runner
    packs: list[tuple[int, int, int]] = []
    batch = runner.prefill_batch

    def spy(toks, tables, *a, **kw):
        if len(toks) > 1:
            packs.append((len(toks), len(toks[0]), len(tables[0])))
        return batch(toks, tables, *a, **kw)

    engine.args.prefill_batch_max, engine.args.prefill_tail_split = PACKED_ROWS, False
    runner.prefill_batch = spy
    try:
        outs, st = await burst("packed prefill")
    finally:
        del runner.prefill_batch
        engine.args.prefill_batch_max, engine.args.prefill_tail_split = 1, True
    if sorted(packs) != [(2, 1024, 128), (2, 2048, 128)]:
        raise RuntimeError(f"{tag}[packed prefill]: packed dispatches {packs}, not two pairs")
    st["packs"] = packs
    st["vs_singles"] = against_dense("packed prefill", outs, dense)
    log(f"{tag}[packed prefill]: prefill_batch_max {PACKED_ROWS}: packed dispatches (rows, T, "
        f"W) {packs}, prefill dispatch {st['prefill_dispatch_s']:.3f}s of host time against "
        f"{singles['prefill_dispatch_s']:.3f}s for singles ({card_line})")
    return st


def _first_divergence(a: list, b: list) -> int | None:
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def verify_rows(runner, S1: int, lens=None) -> dict:
    """Prefill 8 rows of random prompts of lengths ``lens`` (the burst's row
    lengths by default) on ``runner`` and decode each row's greedy
    continuation of S1-1 tokens → the rows' first tokens, tables and
    continuations. A verify pass over them writes every slot it attends
    before it reads it, so several passes may share the rows."""
    import numpy as np

    args, V = runner.args, runner.cfg.vocab_size
    lens = np.asarray(BURST_HIST if lens is None else lens)
    B, bs = len(lens), args.block_size
    rng = np.random.default_rng(70 + S1)
    tables, nxt, first = [], 1, []
    for n in lens:
        nblk = -(-(int(n) + 2 * S1 + 1) // bs)
        tables.append(list(range(nxt, nxt + nblk)))
        nxt += nblk
        toks = np.zeros((-(-int(n) // bs) * bs,), np.int32)
        toks[:n] = rng.integers(1, V, n)
        lg = runner.prefill_chunk(toks, np.asarray(tables[-1], np.int32), 0, int(n), eager=True)
        first.append(int(lg.argmax()))
    W = args.bucket_table(max(len(t) for t in tables))
    tab = np.zeros((B, W), np.int32)
    for i, t in enumerate(tables):
        tab[i, : len(t)] = t
    z = np.zeros((B,), np.int32)
    K = S1 - 1
    ref = runner.multi_decode(
        K, "greedy", np.asarray(first, np.int32), None, lens.astype(np.int32), tab,
        np.ones((B,), bool), np.zeros((B,), np.float32), z, z, z, np.ones((B,), np.float32),
        np.zeros((B,), np.float32), np.zeros((B,), np.float32), np.full((B, 1), -1, np.int32),
        eager=True)
    return dict(lens=lens, first=first, tables=tab, chain=ref.arrs[0].cpu().numpy().T)


def verify_inputs(runner, S1: int, kind: str, mode: str = "simple", lens=None, rows=None):
    """The operands of a verify pass over ``rows`` (``verify_rows``, made
    here when not given) with each row's greedy continuation as its draft:
    ``kind`` "linear" (row 1's third draft token made wrong) or "tree"
    (TREE_PARENTS[S1]: the first child of each node on the accepted path
    carries the continuation, its siblings other tokens). Rows 3 and 6
    sample at temperature 0.7 in "simple" mode."""
    import numpy as np

    rows = rows or verify_rows(runner, S1, lens)
    lens, first, tab, chain = rows["lens"], rows["first"], rows["tables"], rows["chain"]
    B, V = len(lens), runner.cfg.vocab_size
    tokens = np.zeros((B, S1), np.int32)
    tokens[:, 0] = first
    tree = None
    if kind == "tree":
        parents = [0] + TREE_PARENTS[S1]
        anc = np.zeros((S1, S1), np.int8)
        depth = np.zeros((S1,), np.int32)
        on_path, kids = {0}, {}
        anc[0, 0] = 1
        for j in range(1, S1):
            p = parents[j]
            anc[j] = anc[p]
            anc[j, j] = 1
            depth[j] = depth[p] + 1
            kids[p] = kids.get(p, 0) + 1
            if p in on_path and kids[p] == 1:
                on_path.add(j)
                tokens[:, j] = chain[:, depth[j] - 1]
            else:
                tokens[:, j] = (chain[:, depth[j] - 1] + 1 + kids[p]) % V
        tree = (np.tile(np.asarray(parents, np.int32), (B, 1)), np.tile(anc, (B, 1, 1)),
                np.tile(depth, (B, 1)))
    else:
        tokens[:, 1:] = chain
        tokens[1, 3 % S1] = (tokens[1, 3 % S1] + 1) % V
    temps = np.zeros((B,), np.float32)
    if mode == "simple":
        temps[[3, 6]] = 0.7
    return dict(S1=S1, mode=mode, tokens=tokens, positions0=lens.astype(np.int32),
                draft_len=np.full((B,), S1 - 1, np.int32), tables=tab,
                active=np.ones((B,), bool), temps=temps,
                seeds=np.arange(1000, 1000 + B, dtype=np.int32), steps0=np.ones((B,), np.int32),
                fold_slots=np.arange(B, dtype=np.int32), top_n=0, tree=tree)


def verify_graph_vs_eager(runner, kw):
    """One verify pass as a CUDA-graph replay and op by op from the same
    device state; raise unless every output, the KV pages (block 0 aside)
    and the chain buffer (sink slot aside) are bit-identical. → n_emit."""
    import torch

    before = _device_state(runner)
    runs = []
    for eager in (False, True):
        _restore(runner, before)
        outs = [a.clone() for a in runner.spec_verify(**kw, eager=eager).arrs]
        runs.append((outs, _device_state(runner)))
    torch.cuda.synchronize()
    (g_out, g_state), (e_out, e_state) = runs
    names = ("out", "n_emit", "logps", "cand", "top_vals", "top_ids")
    for name, a, b in zip(names, g_out, e_out):
        if not torch.equal(a, b):
            raise RuntimeError(f"verify S1={kw['S1']}: graph and eager passes differ in {name}")
    for i, (a, b) in enumerate(zip(g_state, e_state)):
        a, b = (a[:-1], b[:-1]) if i == len(g_state) - 1 else (a[:, 1:], b[:, 1:])
        if not torch.equal(a, b):
            raise RuntimeError(f"verify S1={kw['S1']}: graph and eager passes differ in device "
                               f"state {i}")
    return g_out[1].cpu().tolist()


def verify_replay_ms(runner, kw) -> float:
    """Device time of one verify pass as a graph replay: the median of 5
    CUDA-event timings after one warm replay."""
    import torch

    runner.spec_verify(**kw)
    times = []
    for _ in range(5):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        runner.spec_verify(**kw)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def verify_timing(engine, card_line: str, tag: str) -> dict:
    """Verify passes at the burst's row lengths on the engine's weights and
    KV page format (a runner of its own): graph replay bit-identical to the
    op-by-op pass for linear fused, stepwise and tree passes at S1 = 4 and
    7, each pass's replay device time, and one dense substep's (a K=8 greedy
    window replay over the same rows, per substep)."""
    import dataclasses

    import numpy as np

    from dynamo_tpu_torch.engine.runner import LocalRunner

    args = dataclasses.replace(engine.args, num_kv_blocks=640, spec_tokens=SPEC_TOKENS,
                               spec_fused=True)
    runner = LocalRunner(args, params=engine.runner.params)
    runner.start()
    out = {}
    for S1 in (SPEC_TOKENS + 1, 2 * SPEC_TOKENS + 1):
        rows = verify_rows(runner, S1)
        for kind in ("linear", "stepwise", "tree"):
            runner.args.spec_fused = kind != "stepwise"
            kw = verify_inputs(runner, S1, "tree" if kind == "tree" else "linear", rows=rows)
            n_emit = verify_graph_vs_eager(runner, kw)
            ms = verify_replay_ms(runner, kw)
            out[f"{kind}_S1_{S1}_ms"] = ms
            log(f"{tag}: {kind} verify pass, S1={S1}, 8 rows at the burst's lengths: graph "
                f"replay bit-identical to op by op, n_emit {n_emit}, {ms:.3f} ms device time "
                f"per replay ({card_line})")
    runner.args.spec_fused = True
    B = len(BURST_HIST)
    z = np.zeros((B,), np.int32)
    kw = dict(K=8, mode="greedy", tokens=kw["tokens"][:, 0].copy(), chain=None,
              positions=kw["positions0"], tables=kw["tables"], active=np.ones((B,), bool),
              temps=np.zeros((B,), np.float32), seeds=z, steps0=z, tks=z,
              tps=np.ones((B,), np.float32), freqs=np.zeros((B,), np.float32),
              press=np.zeros((B,), np.float32), pen=np.full((B, 1), -1, np.int32), top_n=0)
    out["dense_substep_ms"] = replay_ms(runner, kw)
    log(f"{tag}: one dense substep at the same lengths (K=8 greedy window replay / 8): "
        f"{out['dense_substep_ms']:.3f} ms device time ({card_line})")
    runner.stop()
    return out


async def spec_phase(card_line: str, preset: str = "llama-8b", device: str = "cuda",
                     dtype: str = "bfloat16", quant: str = "none", kv_quant: str = "none",
                     model=None):
    """Phase 10: the burst through ``run``'s pipeline with ``--spec-tokens
    3 --spec-ngram 1`` (spec_gate 0 on the engine), in turn dense
    (spec_tokens 0, the reference), linear fused (twice: the repeat must
    give the same streams), linear stepwise (greedy streams bit-equal to
    dense) and tree (width 2, depth 3), every request asking for its top-2
    logprobs and every verify shape captured ahead of its burst. Each
    speculating burst must dispatch verify passes and holds the launch
    counts: attention = layers × (dense substeps + verify forwards: 1 per
    fused pass, S1 per stepwise pass), int8 = 225 per forward (the wide
    entry for fused and tree passes, the decode kernel for stepwise ones,
    none on the prefill route), no eager window or verify pass on the
    card.

    Which tokens a verify pass computes (and so their rounding in bf16,
    and a sampled row's noise keys) depends on when passes happen, so the
    phase makes that a function of the requests alone: the engine runs
    unpipelined (a row drafts on its whole history, not on what the host
    has fetched so far) and each burst's 8 requests are all queued before
    the scheduler admits any (it is held by ``run_on_engine_thread``
    meanwhile), so they admit as one wave. ``model``: a ModelConfig in
    place of the preset's (``cut_config``)."""
    import numpy as np
    import torch

    from dynamo_tpu_torch.engine.graphs import COUNTERS
    from dynamo_tpu_torch.llm.protocols import CompletionRequest
    from dynamo_tpu_torch.run.__main__ import parse_args
    from dynamo_tpu_torch.runtime.engine import Context

    cuda = device == "cuda"
    tag = f"spec[{'int8' if quant == 'int8' else dtype} weights, {kv_quant} KV]"
    args = parse_args(["--in", "batch:-", "--preset", preset, "--dtype", dtype,
                       "--device", device, *ENGINE_ARGV, "--spec-tokens", str(SPEC_TOKENS),
                       "--spec-ngram", str(SPEC_NGRAM)])
    t0 = time.perf_counter()
    pipe = await local_pipeline(args, quant=quant, kv_quant=kv_quant, model=model)
    engine, runner = pipe.engine, pipe.engine.runner
    cfg, L = engine.cfg, engine.cfg.num_layers
    engine.set_spec(spec_gate=0.0)
    engine.args.pipeline_depth = 0
    g = runner.graphs
    # Every burst asks for each position's top-2 logprobs (the dense
    # burst's gaps are the reference of the comparisons): one ranked width.
    n_win = runner.warm_windows(("greedy", "simple"), (engine.args.top_logprobs_max,))
    log(f"{tag}: {cfg.name} ({L} layers) pipeline up in {time.perf_counter() - t0:.1f}s, "
        f"{n_win} window graphs")
    prompts = burst_prompts()
    greedy_rows = [i for i, t in enumerate(BURST_TEMPS) if t == 0.0]

    def warm(label):
        if g is None:
            return {}
        pool0, cap0, t1 = g.pool_bytes(), g.capture_s, time.perf_counter()
        n = runner.warm_spec(("greedy", "simple"), (engine.args.top_logprobs_max,))
        st = {"graphs": n, "capture_s": g.capture_s - cap0,
              "pool_bytes_added": g.pool_bytes() - pool0, "pool_bytes": g.pool_bytes()}
        log(f"{tag}: {label} verify lattice: {n} graphs captured in {st['capture_s']:.2f}s "
            f"({time.perf_counter() - t1:.2f}s wall), graph pool +"
            f"{st['pool_bytes_added'] / 2**20:.1f} MiB to {st['pool_bytes'] / 2**20:.1f} MiB "
            f"({card_line})")
        return st

    async def one(i, top):
        req = CompletionRequest.parse({
            "model": pipe.card.name, "prompt": prompts[i], "max_tokens": BURST_TOKENS,
            "temperature": BURST_TEMPS[i], "seed": 1000 + i, "ignore_eos": True,
            "logprobs": top,
        })
        gen = None
        async for g_, _chunk in pipe.run(req, Context()):
            gen = g_
        return {"tokens": list(gen.lp_tokens), "logprobs": list(gen.lp_values),
                "tops": list(gen.lp_tops)}

    async def burst(label, top=2):
        engine.clear_kv_blocks()  # every burst prefills cold
        steps0, rows0 = engine.total_decode_steps, (engine.total_row_passes,
                                                     engine.total_row_tokens)
        spec0 = {k: getattr(engine, f"total_spec_{k}") for k in (
            "passes", "rows", "proposed", "accepted", "emitted", "tree_passes")}
        ver0 = (runner.verify_passes, runner.verify_forwards, runner.verify_calls,
                runner.tree_verify_calls)
        eager0 = (runner.eager_windows, runner.eager_verifies, runner.eager_prefills)
        phase0 = _counters(engine)[1].get("prefill_dispatch", 0.0)
        zero_counts()
        entered, gate = threading.Event(), threading.Event()

        def hold():
            entered.set()
            gate.wait(120)

        held = asyncio.ensure_future(engine.run_on_engine_thread(hold))
        while not entered.is_set():
            await asyncio.sleep(0.001)
        tasks = [asyncio.ensure_future(one(i, top)) for i in range(len(prompts))]
        deadline = time.perf_counter() + 60
        while engine.metrics().worker.num_requests_waiting < len(prompts):
            if time.perf_counter() > deadline or any(t.done() for t in tasks):
                gate.set()
                break
            await asyncio.sleep(0.001)
        t1 = time.perf_counter()
        gate.set()
        await held
        outs = await asyncio.gather(*tasks)
        wall = time.perf_counter() - t1
        while engine.busy():
            await asyncio.sleep(0.001)
        launches = int8_counts()
        substeps = engine.total_decode_steps - steps0
        passes = runner.verify_passes - ver0[0]
        forwards = runner.verify_forwards - ver0[1]
        vcalls = tuple(b - a for a, b in zip(ver0[2], runner.verify_calls))
        tcalls = tuple(b - a for a, b in zip(ver0[3], runner.tree_verify_calls))
        spec = {k: getattr(engine, f"total_spec_{k}") - v for k, v in spec0.items()}
        row_passes = engine.total_row_passes - rows0[0]
        row_tokens = engine.total_row_tokens - rows0[1]
        for i, o in enumerate(outs):
            if len(o["tokens"]) != BURST_TOKENS or not all(
                    np.isfinite(lp) and lp <= 0.0 for lp in o["logprobs"]):
                raise RuntimeError(f"{tag}[{label}] request {i}: bad token/logprob stream")
            if not all(0 <= t < cfg.vocab_size for t in o["tokens"]):
                raise RuntimeError(f"{tag}[{label}] request {i}: token id out of range")
        per_fwd = verify_per_forward(L, cuda, quant == "int8", stepwise=label == "stepwise")
        if launches[0] != per_fwd[0] * (substeps + forwards):
            raise RuntimeError(f"{tag}[{label}]: paged_attention launches {launches[0]} != "
                               f"{L} x (dense substeps {substeps} + verify forwards {forwards})")
        if tuple(vcalls) != tuple(n * forwards for n in per_fwd):
            raise RuntimeError(f"{tag}[{label}]: verify passes made {dict(zip(COUNTERS, vcalls))} "
                               f"kernel calls for {forwards} forwards; want "
                               f"{tuple(n * forwards for n in per_fwd)} (attention, int8 kernel, "
                               f"int8 prefill route, int8 tied head, int8 wide entry)")
        if tcalls != tuple(n * spec["tree_passes"] for n in per_fwd):
            raise RuntimeError(f"{tag}[{label}]: tree verify passes made {tcalls} kernel calls "
                               f"for {spec['tree_passes']} passes")
        if label not in ("dense", "packed prefill") and passes == 0:
            raise RuntimeError(f"{tag}[{label}]: no verify pass was dispatched")
        eager = (runner.eager_windows - eager0[0], runner.eager_verifies - eager0[1],
                 runner.eager_prefills - eager0[2])
        if cuda and eager != (0, 0, 0):
            raise RuntimeError(f"{tag}[{label}]: {eager[0]} windows, {eager[1]} verify passes "
                               f"and {eager[2]} prefills ran eagerly on the card")
        st = {"wall_s": wall, "tokens_per_s": len(prompts) * BURST_TOKENS / wall,
              "substeps": substeps, "verify_passes": passes, "verify_forwards": forwards,
              "attention_launches": launches[0], "int8_launches": launches[1],
              "int8_prefill_launches": launches[2], "int8_wide_launches": launches[3],
              "verify_attention_launches": vcalls[0], "tree_verify_attention_launches": tcalls[0],
              "verify_calls_per_pass": [c / max(1, passes) for c in vcalls],
              "tokens_per_weight_pass": row_tokens / max(1, row_passes),
              "accept_rate": spec["accepted"] / max(1, spec["proposed"]),
              "prefill_dispatch_s": _counters(engine)[1].get("prefill_dispatch", 0.0) - phase0,
              **spec}
        log(f"{tag}[{label}]: 8 requests x {BURST_TOKENS} tokens in {wall:.3f}s → "
            f"{st['tokens_per_s']:.1f} tokens/s; {substeps} dense substeps, {passes} verify "
            f"passes ({spec['tree_passes']} branched, {forwards} forwards), "
            f"{st['tokens_per_weight_pass']:.3f} tokens per weight pass, accept rate "
            f"{st['accept_rate']:.3f} ({spec['accepted']}/{spec['proposed']}) ({card_line})")
        log(f"{tag}[{label}]: paged_attention launches {launches[0]} = {L} x ({substeps} + "
            f"{forwards}); per verify pass: attention {st['verify_calls_per_pass'][0]:.1f}, "
            f"int8 kernel {st['verify_calls_per_pass'][1]:.1f}, int8 prefill route "
            f"{st['verify_calls_per_pass'][2]:.1f}, int8 wide entry "
            f"{st['verify_calls_per_pass'][4]:.1f}")
        return outs, st

    def against_dense(label, outs, dense):
        """Greedy rows against the dense burst: → divergences allowed by the
        gap rule, the largest dense top-2 gap among them, and the largest
        |logprob - dense| on the common prefixes."""
        n_div, gaps, drift = 0, [], 0.0
        for i in greedy_rows:
            d, o = dense[i], outs[i]
            p = _first_divergence(o["tokens"], d["tokens"])
            end = BURST_TOKENS if p is None else p
            if end:
                drift = max(drift, max(abs(a - b) for a, b in
                                       zip(o["logprobs"][:end], d["logprobs"][:end])))
            if p is None:
                continue
            tops = sorted((lp for _tok, lp in d["tops"][p]), reverse=True)
            gap = tops[0] - tops[1]
            if gap >= SPEC_GAP_TOL:
                raise RuntimeError(f"{tag}[{label}] request {i}: greedy stream leaves the dense "
                                   f"stream at token {p}, where the dense top-2 gap is "
                                   f"{gap:.4f} >= {SPEC_GAP_TOL}")
            n_div += 1
            gaps.append(gap)
        log(f"{tag}[{label}]: {len(greedy_rows)} greedy streams against dense: {n_div} leave "
            f"it, each where the dense top-2 gap is under {SPEC_GAP_TOL} (gaps "
            f"{[round(x, 4) for x in gaps]}); max |logprob - dense| before that {drift:.4g}")
        return {"divergences": n_div, "gaps": gaps, "max_logprob_drift": drift}

    result = {"window_graphs": n_win, "layers": L}
    engine.set_spec(spec_tokens=0)
    dense, result["dense"] = await burst("dense")
    if quant == "none":
        result["packed_prefill"] = await packed_prefill_pass(engine, burst, against_dense, dense,
                                                             result["dense"], tag, card_line)
    engine.set_spec(spec_tokens=SPEC_TOKENS)
    result["fused_lattice"] = warm("linear fused")
    fused, result["fused"] = await burst("fused")
    again, _ = await burst("fused repeat")
    if any(a["tokens"] != b["tokens"] or a["logprobs"] != b["logprobs"]
           for a, b in zip(fused, again)):
        raise RuntimeError(f"{tag}: the fused burst's repeat gave other streams")
    log(f"{tag}: the fused burst again (same seeds): all 8 streams identical")
    result["fused"]["vs_dense"] = against_dense("fused", fused, dense)

    engine.set_spec(spec_fused=False)
    result["stepwise_lattice"] = warm("linear stepwise")
    stepwise, result["stepwise"] = await burst("stepwise")
    for i in greedy_rows:
        if stepwise[i] != dense[i]:
            raise RuntimeError(f"{tag}: stepwise greedy stream {i} differs from the dense one")
    log(f"{tag}: stepwise verify: the {len(greedy_rows)} greedy streams equal the dense ones "
        "bit for bit (tokens, logprobs, top-2)")

    engine.set_spec(spec_fused=True, **SPEC_TREE)
    result["tree_lattice"] = warm("tree (width 2, depth 3)")
    tree, result["tree"] = await burst("tree")
    if result["tree"]["tree_passes"] == 0:
        raise RuntimeError(f"{tag}: the tree burst dispatched no branched pass")
    result["tree"]["vs_dense"] = against_dense("tree", tree, dense)
    if g is not None:
        verify = [k for k in g.shapes if k[0] == "verify"]
        prefill = [k for k in g.shapes if k[0] == "prefill"]
        result["verify_graphs"] = len(verify)
        result["prefill_graphs"] = len(prefill)
        result["graph_pool_bytes"] = g.pool_bytes()
        log(f"{tag}: {len(verify)} verify graphs, {len(prefill)} prefill graphs (captured at "
            f"first use) and {g.captured - len(verify) - len(prefill)} window graphs in one "
            f"pool of {g.pool_bytes() / 2**20:.1f} MiB ({card_line})")
    if cuda:
        result["timing"] = verify_timing(engine, card_line, tag)
    await engine.stop()
    del pipe, engine, runner
    if cuda:
        torch.cuda.empty_cache()
    return result


# -- phase 11: disaggregated prefill/decode between port workers --------------


def suffix_len(n: int, bs: int = 16) -> int:
    """Tokens a decode worker prefills itself over an injected prompt: the
    prefill worker exports full blocks only, (n - 1) // bs of them."""
    return n - bs * ((n - 1) // bs)


def usr1_counters(proc: Proc, timeout: float = 60.0) -> dict:
    """SIGUSR1 a worker and read the engine_counters line it prints."""
    seen = len(proc.lines)
    proc.proc.send_signal(signal.SIGUSR1)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for line in proc.lines[seen:]:
            if line.startswith('{"event": "engine_counters"'):
                return json.loads(line)
        time.sleep(0.05)
    raise RuntimeError(f"{proc.name}: no engine_counters line after SIGUSR1")


DRAIN_KEYS = ("decode_substeps", "prefilled_tokens", "paged_attention_launches",
              "int8_matmul_launches", "int8_matmul_wide_launches",
              "int8_matmul_prefill_launches")


def settled_counters(proc: Proc, keys=DRAIN_KEYS, timeout: float = 60.0,
                     interval: float = 0.25) -> dict:
    """SIGUSR1 ``proc`` until two readings ``interval`` apart agree on
    ``keys`` (the windows and prefills it had in flight have drained) → the
    last reading. Past ``timeout`` it raises with both readings."""
    deadline = time.monotonic() + timeout
    last = usr1_counters(proc)
    while True:
        time.sleep(interval)
        now = usr1_counters(proc)
        if all(now[k] == last[k] for k in keys):
            return now
        if time.monotonic() > deadline:
            raise RuntimeError(f"{proc.name}: counters still moving after {timeout:.0f}s: "
                               f"{ {k: last[k] for k in keys} } then { {k: now[k] for k in keys} }")
        last = now


def _disagg_sums(text: str) -> dict:
    """Disagg series of a worker's /metrics: remote prefills, fallbacks by
    reason, transfer bytes."""
    fallbacks = {m.group(1): float(m.group(2)) for m in re.finditer(
        r'^dynamo_tpu_disagg_fallback_total\{reason="([^"]*)"\} ([0-9.eE+-]+)$', text, re.M)}
    return {"remote": _metric(text, "dynamo_tpu_disagg_remote_prefill_total") or 0.0,
            "fallbacks": fallbacks,
            "bytes": _metric(text, "dynamo_tpu_disagg_kv_transfer_bytes_total") or 0.0}


def disagg_phase(card_line: str, reference, agg_ttft: tuple | None = None,
                 preset: str = "llama-8b", device: str = "cuda", dtype: str = "bfloat16",
                 quant: str = "none", kv_quant: str = "none",
                 model_path: str | None = None, chaos: bool = True) -> dict:
    """Phase 11: the port's store server, one ``--is-prefill-worker`` and
    one default worker (``--disagg auto``, ``--max-local-prefill-length
    512``) on the same weights, and a kv-mode frontend; the burst as 8
    aggregate /v1/completions. ``reference``: the in-process burst under
    "burst" (cold) and the requests of ``REMOTE`` served again on their
    cached prefixes under "repeats"; ``agg_ttft``: (label, per-request
    TTFT) of an aggregated run to print beside this phase's. With
    ``model_path`` the workers serve that checkpoint (``checkpoint_reference``
    makes the reference on it). ``reference`` may be a function that makes
    it: it then runs while the workers start, and ``agg_ttft`` defaults to
    its burst's TTFTs. Without ``chaos`` the fault path (a prefill worker
    that cuts every transfer, and the decode worker's fallback) is left
    out."""
    from dynamo_tpu_torch.engine.config import EngineArgs

    tag = "disagg" if quant == "none" else f"disagg-int8-kv{kv_quant}"
    cfg, weights = model_source(preset, model_path)
    model = cfg.name
    bs = int(ENGINE_ARGV[ENGINE_ARGV.index("--block-size") + 1])
    block_bytes = EngineArgs(model=cfg, block_size=bs, dtype=dtype,
                             kv_quant=kv_quant).kv_bytes_per_block()
    argv = [*weights, "--dtype", dtype, "--device", device, "--quant", quant,
            "--kv-quant", kv_quant, *ENGINE_ARGV]
    procs: list[Proc] = []
    store_port = _free_port()
    store_url = f"tcp://127.0.0.1:{store_port}"

    def prefill_worker(name: str, env: dict | None = None, wait: bool = True) -> Proc:
        p = Proc(name, ["dynamo_tpu_torch.worker", "--store-url", store_url,
                        "--is-prefill-worker", "--component", "prefill", *argv], env=env)
        procs.append(p)
        if wait:
            registered(p)
        return p

    def registered(p: Proc) -> None:
        _, secs = p.wait_for(r"prefill worker: serving", 600)
        log(f"{tag}: {p.name} registered {secs:.2f}s after launch ({card_line})")

    try:
        store = Proc(f"{tag}-store", ["dynamo_tpu_torch.runtime.store_server", "--host",
                                      "127.0.0.1", "--port", str(store_port)])
        procs.append(store)
        store.wait_for(r"store server: tcp://", 60)
        sys_port = _free_port()
        decode = Proc(f"{tag}-decode", [
            "dynamo_tpu_torch.worker", "--store-url", store_url,
            "--max-local-prefill-length", str(MAX_LOCAL_PREFILL), *argv],
            env={"DYNTPU_SYSTEM_ENABLED": "1", "DYNTPU_SYSTEM_PORT": str(sys_port)})
        procs.append(decode)
        prefill = prefill_worker(f"{tag}-prefill", wait=False)
        if callable(reference):
            reference = reference()
            agg_ttft = agg_ttft or ("in process", [r["ttft_s"] for r in reference["burst"]])
        registered(prefill)
        _, secs = decode.wait_for(r"worker: serving .* window graphs captured", 600)
        log(f"{tag}: decode worker registered {secs:.2f}s after launch ({card_line})")
        fe = Proc(f"{tag}-frontend", ["dynamo_tpu_torch.frontend", "--store-url", store_url,
                                      "--host", "127.0.0.1", "--port", "0", "--router-mode",
                                      "kv"])
        procs.append(fe)
        port = int(fe.wait_for(r"frontend: http://127\.0\.0\.1:(\d+)", 120)[0].group(1))

        # The burst: 4 remote, 4 local; every response held to its reference.
        rs, wall = asyncio.run(_disagg_burst(port, model, list(range(8))))
        for i, r in enumerate(rs):
            ref = reference["repeats"][i] if i in REMOTE else reference["burst"][i]
            _check_disagg(f"{tag} request {i} ({'remote' if i in REMOTE else 'local'})", r, ref)
        dc = settled_counters(decode)
        pc = settled_counters(prefill)
        metrics = _disagg_sums(_get_text(sys_port, "/metrics"))
        dg = dc["disagg"]
        transfers = sorted(dg["transfers"], key=lambda t: t["prompt_tokens"])
        remote_lens = [BURST_LENS[i] for i in REMOTE]
        if (dg["remote_prefills"] != len(REMOTE) or dg["local_fallbacks"]
                or metrics["remote"] != len(REMOTE) or any(metrics["fallbacks"].values())
                or [t["prompt_tokens"] for t in transfers] != remote_lens
                or any(t["outcome"] != "remote" for t in transfers)):
            raise RuntimeError(f"{tag}: routing: handler {dg}, /metrics {metrics}")
        for t in transfers:
            n_blocks = (t["prompt_tokens"] - 1) // bs
            if t["bytes"] != n_blocks * block_bytes:
                raise RuntimeError(f"{tag}: {t['prompt_tokens']}-token transfer moved "
                                   f"{t['bytes']} bytes, not {n_blocks} x {block_bytes}")
        local_lens = [n for n in BURST_LENS if n <= MAX_LOCAL_PREFILL]
        d_lens = local_lens + [suffix_len(n, bs) for n in remote_lens]
        want_prefilled = sum(d_lens)
        if dc["prefilled_tokens"] != want_prefilled or pc["prefilled_tokens"] != sum(remote_lens):
            raise RuntimeError(f"{tag}: prefilled tokens decode {dc['prefilled_tokens']} (want "
                               f"{want_prefilled}), prefill {pc['prefilled_tokens']} (want "
                               f"{sum(remote_lens)})")
        counts = _held_counts(tag, "decode worker", dc, cfg, d_lens, device, quant)
        p_counts = _held_counts(tag, "prefill worker", pc, cfg, remote_lens, device, quant)
        if pc["decode_substeps"] != 0:
            raise RuntimeError(f"{tag}: the prefill worker decoded ({pc['decode_substeps']} "
                               "substeps)")
        ttft = [asyncio.run(routed(port, r["trace_id"]))[1] for r in rs]
        phase = dc["phase_s"]
        decode_s = sum(phase.get(k, 0.0) for k in DECODE_PHASES)
        drain_sync_share = phase.get("drain_sync", 0.0) / decode_s if decode_s else 0.0
        for t in transfers:
            t["mb_per_s"] = t["bytes"] / t["seconds"] / 1e6
            log(f"{tag}: remote request of {t['prompt_tokens']} tokens: {t['bytes']} bytes in "
                f"{t['chunks']} chunk(s), overlap_frac {t['overlap_frac']}, dispatch + pull "
                f"{t['seconds']:.3f}s → {t['mb_per_s']:.1f} MB/s ({card_line})")
        for i, t in enumerate(ttft):
            vs = f", {agg_ttft[0]} {agg_ttft[1][i] * 1e3:.1f} ms" if agg_ttft else ""
            log(f"{tag}: request {i} ({BURST_LENS[i]} tokens, "
                f"{'remote' if i in REMOTE else 'local'}) ledger TTFT {t * 1e3:.1f} ms{vs} "
                f"({card_line})")
        log(f"{tag}: 8 requests, {8 * BURST_TOKENS} tokens in {wall:.3f}s → "
            f"{8 * BURST_TOKENS / wall:.1f} tokens/s; decode worker: drain_sync "
            f"{100 * drain_sync_share:.1f}% of its decode-phase host time, inject "
            f"{dc['inject_s']:.3f}s on the scheduler thread for {dc['inject_bytes']} bytes; "
            f"prefill worker: export {pc['export_s']:.3f}s on its scheduler thread; launches "
            f"(attention, int8 kernel, int8 prefill route, int8 wide entry) decode {counts}, "
            f"prefill {p_counts} "
            f"({card_line})")
        log(f"{tag}: routing exact: requests {REMOTE} remote ({remote_lens} tokens), the rest "
            f"local; disagg_remote_prefill_total {metrics['remote']:.0f}, fallbacks "
            f"{metrics['fallbacks'] or 0}; remote streams equal the in-process prefix-hit "
            f"passes, local ones the cold burst, bit for bit (token texts and logprobs)")

        # The longest prompt alone, from an empty cache: one transfer with
        # nothing else on either worker, beside the burst's four.
        asyncio.run(clear_kv(port, model, workers=1))
        (r,), _ = asyncio.run(_disagg_burst(port, model, [CHAOS_REQUEST], "alone"))
        _check_disagg(f"{tag} request {CHAOS_REQUEST} alone", r,
                      reference["repeats"][CHAOS_REQUEST])
        alone_ttft = asyncio.run(routed(port, r["trace_id"]))[1]
        dc1 = settled_counters(decode)
        alone = dc1["disagg"]["transfers"][-1]
        if dc1["disagg"]["remote_prefills"] != len(REMOTE) + 1 or alone["outcome"] != "remote":
            raise RuntimeError(f"{tag}: request {CHAOS_REQUEST} alone: {dc1['disagg']}")
        alone["mb_per_s"] = alone["bytes"] / alone["seconds"] / 1e6
        delta = {k: dc1[k] - dc[k] for k in DRAIN_KEYS}
        _held_counts(tag, "decode worker (request alone)", delta, cfg,
                     [suffix_len(BURST_LENS[CHAOS_REQUEST], bs)], device, quant)
        log(f"{tag}: request {CHAOS_REQUEST} alone ({BURST_LENS[CHAOS_REQUEST]} tokens, remote): "
            f"{alone['bytes']} bytes, dispatch + pull {alone['seconds']:.3f}s → "
            f"{alone['mb_per_s']:.1f} MB/s, ledger TTFT {alone_ttft * 1e3:.1f} ms; its stream "
            f"equals the in-process prefix-hit pass ({card_line})")

        # Fault path: a prefill worker that cuts every transfer after its
        # first chunk; the decode worker's cache cleared so the request
        # goes remote again, falls back and prefills locally (cold).
        rcs = {prefill.name: prefill.stop()}
        dc2 = None
        if chaos:
            asyncio.run(clear_kv(port, model, workers=1))
            cutter = prefill_worker(f"{tag}-prefill-chaos", env={
                "DYNTPU_CHAOS_ENABLED": "1", "DYNTPU_CHAOS_TRANSFER_CUT_P": "1"})
            time.sleep(1.0)  # the decode worker's discovery sees the new instance
            (r,), _ = asyncio.run(_disagg_burst(port, model, [CHAOS_REQUEST], "chaos"))
            _check_disagg(f"{tag} chaos request {CHAOS_REQUEST}", r,
                          reference["burst"][CHAOS_REQUEST])
            dc2 = settled_counters(decode)
            metrics2 = _disagg_sums(_get_text(sys_port, "/metrics"))
            if (dc2["disagg"]["fallback_reasons"] != {"transfer": 1}
                    or dc2["disagg"]["remote_prefills"] != len(REMOTE) + 1
                    or metrics2["fallbacks"] != {"transfer": 1.0}):
                raise RuntimeError(f"{tag}: chaos: handler {dc2['disagg']}, /metrics {metrics2}")
            delta = {k: dc2[k] - dc1[k] for k in DRAIN_KEYS}
            _held_counts(tag, "decode worker (chaos rerun)", delta, cfg,
                         [BURST_LENS[CHAOS_REQUEST]], device, quant)
            log(f"{tag}: chaos: DYNTPU_CHAOS_TRANSFER_CUT_P=1 on the prefill worker cut request "
                f"{CHAOS_REQUEST}'s transfer; the decode worker fell back to a local prefill "
                f"(disagg_fallback_total{{reason=\"transfer\"}} 1) and returned the cold "
                f"burst's stream bit for bit")
            rcs[cutter.name] = cutter.stop()
        rcs.update({p.name: p.stop() for p in [fe, decode, store]})
        if any(rcs.values()):
            raise RuntimeError(f"{tag}: processes did not exit 0 on SIGTERM: {rcs}")
        final = next(json.loads(line) for line in reversed(decode.lines)
                     if line.startswith('{"event": "engine_counters"'))
        return {"tokens_per_s": 8 * BURST_TOKENS / wall, "wall_s": wall, "ttft_s": ttft,
                "remote": REMOTE, "transfers": transfers, "launches": counts,
                "prefill_launches": p_counts, "decode_substeps": dc["decode_substeps"],
                "drain_sync_share": drain_sync_share, "inject_s": dc["inject_s"],
                "inject_bytes": dc["inject_bytes"], "export_s": pc["export_s"],
                "phase_s": phase, "prefill_phase_s": pc["phase_s"], "metrics": metrics,
                "alone": dict(alone, ttft_s=alone_ttft),
                "chaos": None if dc2 is None else dc2["disagg"],
                "final_counters": final, "exit_codes": rcs}
    finally:
        for p in procs:
            p.kill()


def _held_counts(tag, who, c, cfg, lens, device, quant) -> tuple[int, int, int, int]:
    """Hold a worker's launch counters to the count its substeps and
    prefills give → (attention, int8 kernel, int8 prefill route, int8 wide
    entry)."""
    got = worker_counts(c)
    want = _ckpt_counts(cfg, c["decode_substeps"], device, lens)
    if quant != "int8":
        want = (want[0], 0, 0, 0)
    if got != want:
        raise RuntimeError(f"{tag}: {who} launches (attention, int8 kernel, int8 prefill "
                           f"route, int8 wide entry) {got} != {want} for "
                           f"{c['decode_substeps']} substeps")
    return got


def _get_text(port: int, path: str) -> str:
    _, _, pieces, _ = asyncio.run(http_request(port, path, method="GET"))
    return b"".join(p for _, p in pieces).decode()


async def _disagg_burst(port: int, model: str, idx: list[int], label: str = "burst"):
    """The burst's requests ``idx`` at once as aggregate completions →
    (responses, wall seconds)."""
    await _wait_listed(port, model)
    prompts = burst_prompts()
    base = {"burst": 0xE00, "alone": 0xE80}.get(label, 0xF00)
    t0 = time.perf_counter()
    rs = await asyncio.gather(*(http_completion(port, {
        "model": model, "prompt": prompts[i], "max_tokens": BURST_TOKENS,
        "temperature": BURST_TEMPS[i], "seed": 1000 + i, "ignore_eos": True, "logprobs": 0,
        "stream": False}, f"{base + i:032x}") for i in idx))
    return rs, time.perf_counter() - t0


def _check_disagg(label: str, r: dict, ref: dict) -> None:
    """200, 64 tokens, and the reference's text, token texts and logprobs
    bit for bit; a divergence is reported at its first position."""
    if r["status"] != 200 or r.get("error"):
        raise RuntimeError(f"{label}: status {r['status']} {r.get('error')}")
    if (r["usage"] or {}).get("completion_tokens") != BURST_TOKENS or r["finish"] != "length":
        raise RuntimeError(f"{label}: usage {r['usage']}, finish {r['finish']!r}")
    if r["lp_tokens"] != ref["lp_tokens"] or r["logprobs"] != ref["logprobs"]:
        k = next((j for j, (a, b) in enumerate(zip(r["lp_tokens"], ref["lp_tokens"]))
                  if a != b), None)
        drift = max(abs(a - b) for a, b in zip(r["logprobs"], ref["logprobs"]))
        where = (f"first token divergence at {k}: {r['lp_tokens'][k]!r} (logprob "
                 f"{r['logprobs'][k]}) against {ref['lp_tokens'][k]!r} ({ref['logprobs'][k]}); "
                 f"the two candidates' logprobs differ by "
                 f"{abs(r['logprobs'][k] - ref['logprobs'][k]):.4g}") if k is not None else \
            "tokens equal"
        raise RuntimeError(f"{label}: stream differs from its reference ({where}; max "
                           f"|logprob delta| {drift:.4g})")
    if r["text"] != ref["text"]:
        raise RuntimeError(f"{label}: text differs from its reference")


# -- phase 12: structured output and embeddings ------------------------------

# A bounded json_schema: an enum, a const, a boolean, an integer (the
# compiler caps digit runs at 16) and a string of at most 8 characters. Its
# longest match is 119 bytes (a signed 16-digit integer, every string
# character a \uXXXX escape), so with the byte tokenizer every completion
# ends, EOS included, within GRAMMAR_TOKENS.
GRAMMAR_SCHEMA = {"type": "object", "properties": {
    "kind": {"enum": ["cat", "dog"]}, "v": {"const": 1}, "ok": {"type": "boolean"},
    "n": {"type": "integer"}, "tag": {"type": "string", "maxLength": 8}}}
GRAMMAR_RF = {"type": "json_schema", "json_schema": {"name": "record", "schema": GRAMMAR_SCHEMA}}
GRAMMAR_TOKENS = 128
# Raw top-n alternatives per position asked by every 12a request (the
# ranked-logprob variant of each graph runs).
GRAMMAR_TOP = 8
# Phase 12b's chat pair (streamed, aggregate): long prompts, so each row
# alone takes the widest table bucket, as it does in the burst.
GRAMMAR_HTTP = (7, 6)
# Phase 12b's /v1/embeddings inputs: cuts of the burst's prompts (bytes).
EMBED_CUTS = ((7, 1536), (5, 300), (2, 64), (0, 9))
# 12a holds engine.embed's vectors to embed_f32_reference's, as
# ||vec - ref|| / ||ref||, below this bound. On an H100 at llama-8b (bf16,
# random weights from seed 0) the four cuts read 0.0068-0.0118; the same
# forward without its causal mask reads 1.26-1.41 and the 9-token cut's
# mean over its padded length 0.44, so 0.03 passes the first and fails
# the others.
EMBED_REL_TOL = 0.03
GRAMMAR_LIFT_STATES = 16


def grammar_valid(text: str) -> dict:
    """Parse ``text`` and hold it to GRAMMAR_SCHEMA → the object."""
    obj = json.loads(text)
    ok = (isinstance(obj, dict) and list(obj) == list(GRAMMAR_SCHEMA["properties"])
          and obj["kind"] in ("cat", "dog") and obj["v"] == 1 and type(obj["ok"]) is bool
          and type(obj["n"]) is int and isinstance(obj["tag"], str) and len(obj["tag"]) <= 8)
    if not ok:
        raise RuntimeError(f"grammar: {text!r} does not validate against the schema")
    return obj


def fsm_legal(g, tokens: list[int], eos_ids) -> None:
    """Walk the compiled grammar over a stream's tokens: every text token
    legal in the state it was emitted in, EOS only last and only at a
    terminal state."""
    st = g.start
    for k, t in enumerate(tokens):
        if t in eos_ids:
            if k != len(tokens) - 1 or not g.is_terminal(st):
                raise RuntimeError(f"grammar: EOS at token {k} of {len(tokens)} in a "
                                   f"{'terminal' if g.is_terminal(st) else 'non-terminal'} state")
            return
        nxt = g.advance(st, t)
        if nxt is None:
            raise RuntimeError(f"grammar: token {t} at position {k} is illegal under the FSM")
        st = nxt
    raise RuntimeError("grammar: the stream did not end in EOS")


def embed_f32_reference(cfg, params, ids: list[int], causal: bool = True):
    """The /v1/embeddings vector of ``ids`` from a plain float32 forward
    over the same weights, each layer's cast to f32 in turn: no padding,
    each query attends its own prefix (an explicit lower-triangular mask;
    every token with ``causal=False``, the fault the check must see), and
    the final-norm hidden states are averaged over the tokens. Written
    apart from ``model.embed`` (the JAX ``embed_impl``'s padded forward with
    its -1e9 additive mask) to hold it to. → [D] f32 on the params' device."""
    import torch

    dev = params["embed"].device
    T, H, KVH, hd = len(ids), cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def norm(x, w):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + cfg.rms_norm_eps) * w.float()

    half = hd // 2
    ang = torch.arange(T, device=dev, dtype=torch.float32)[:, None] * torch.pow(
        float(cfg.rope_theta), -torch.arange(half, device=dev, dtype=torch.float32) / half)
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]

    def rope(t):  # rotate-half
        a, b = t[..., :half], t[..., half:]
        return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)

    future = ~torch.ones((T, T), dtype=torch.bool, device=dev).tril(0 if causal else T)
    x = params["embed"][torch.tensor(ids, device=dev).long()].float()
    for i in range(cfg.num_layers):
        lp = {k: v[i].float() for k, v in params["layers"].items()}
        h = norm(x, lp["attn_norm"])
        q, k, v = h @ lp["wq"], h @ lp["wk"], h @ lp["wv"]
        if cfg.attn_bias:
            q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
        q = rope(q.reshape(T, H, hd))
        k = rope(k.reshape(T, KVH, hd)).repeat_interleave(H // KVH, dim=1)
        v = v.reshape(T, KVH, hd).repeat_interleave(H // KVH, dim=1)
        s = torch.einsum("thd,shd->hts", q, k) * hd ** -0.5
        p = s.masked_fill(future, float("-inf")).softmax(dim=-1)
        x = x + torch.einsum("hts,shd->thd", p, v).reshape(T, H * hd) @ lp["wo"]
        h = norm(x, lp["mlp_norm"])
        x = x + (torch.nn.functional.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])) @ lp["w_down"]
    return norm(x, params["final_norm"]).mean(dim=0)


def embed_against_f32(cfg, params, ids_list, vecs, chunk: int, block: int, tag: str) -> dict:
    """Raise unless every vector of ``vecs`` is within EMBED_REL_TOL of
    ``embed_f32_reference`` of its ids (relative L2), pooled over
    ``chunk``-token chunks weighted by their lengths as the engine pools
    inputs longer than max_prefill_tokens. As evidence that the bound sees
    faults, also read each input's distance for the reference without its
    causal mask (raise unless it exceeds the bound) and for the vector
    averaged over its length padded to a ``block`` multiple. → the three
    lists of relative distances: rel_err, no_causal_mask, padded_mean."""
    import numpy as np

    def ref_of(ids, causal):
        return sum(embed_f32_reference(cfg, params, ids[i : i + chunk], causal).cpu().numpy()
                   .astype(np.float64) * len(ids[i : i + chunk])
                   for i in range(0, len(ids), chunk)) / len(ids)

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    out: dict = {"rel_err": [], "no_causal_mask": [], "padded_mean": []}
    for ids, v in zip(ids_list, vecs):
        v, ref = np.asarray(v, np.float64), ref_of(ids, True)
        err, blind = rel(v, ref), rel(ref_of(ids, False), ref)
        if not err < EMBED_REL_TOL:
            raise RuntimeError(f"{tag}: the embedding of {len(ids)} tokens is {err:.4g} (relative "
                               f"L2) from the float32 reference (>= {EMBED_REL_TOL})")
        if not blind >= EMBED_REL_TOL:
            raise RuntimeError(f"{tag}: at {len(ids)} tokens the bound {EMBED_REL_TOL} cannot see "
                               f"a dropped causal mask ({blind:.4g})")
        out["rel_err"].append(err)
        out["no_causal_mask"].append(blind)
        out["padded_mean"].append(rel(v * len(ids) / (-(-len(ids) // block) * block), ref))
    return out


def tree_vs_dense_gaps(dense: list, tree: list, rows, tag: str) -> list[float]:
    """Hold the greedy ``rows``' tree streams to the dense ones: a tree
    stream may leave its dense one only where the two legal tokens are
    within SPEC_GAP_TOL nats of each other, either way round. Both tokens
    at the divergence are legal, each the legal argmax of its own pass: the
    dense token's logprob in the dense pass less the tree token's in the
    tree pass bounds the dense legal top-2 gap up to the passes' rounding
    (the raw top-n lists may hold no legal token); a gap far below 0 means
    a pass that did not take its legal argmax. → the gaps."""
    gaps = []
    for i in rows:
        d, o = dense[i], tree[i]
        p = _first_divergence(o["tokens"], d["tokens"])
        if p is None and len(o["tokens"]) == len(d["tokens"]):
            continue
        if p is None:
            raise RuntimeError(f"{tag}: tree stream {i} is a prefix of the dense one")
        gap = d["logprobs"][p] - o["logprobs"][p]
        if not abs(gap) < SPEC_GAP_TOL:
            raise RuntimeError(f"{tag} request {i}: the tree greedy stream leaves the dense one "
                               f"at token {p}, where the two legal tokens are {gap:.4f} nats "
                               f"apart (|gap| >= {SPEC_GAP_TOL})")
        gaps.append(gap)
    return gaps


def grammar_chat(i: int, prompts, model: str, stream: bool = False) -> dict:
    return {"model": model, "messages": [{"role": "user", "content": prompts[i]}],
            "max_tokens": GRAMMAR_TOKENS, "temperature": BURST_TEMPS[i], "seed": 1000 + i,
            "logprobs": True, "top_logprobs": GRAMMAR_TOP, "response_format": GRAMMAR_RF,
            "stream": stream}


def grammar_states(g, n: int) -> list[int]:
    """n FSM states along one valid record, spread over its bytes."""
    text = b'{"kind": "dog", "v": 1, "ok": true, "n": -4021, "tag": "a\\u00e9b"}'
    states, st = [g.start], g.start
    for b in text:
        st = g.advance(st, b)
        states.append(st)
    return [states[(k * (len(states) - 1)) // max(1, n - 1)] for k in range(n)]


def step_graph_vs_eager(runner, kw):
    """One single step (``runner.decode_sample``, masked or not) as a
    CUDA-graph replay and op by op from the same device state; raise unless every
    output, the KV pages (block 0 aside) and the chain buffer (sink slot
    aside) are bit-identical. → its tokens."""
    import torch

    before = _device_state(runner)
    runs = []
    for eager in (False, True):
        _restore(runner, before)
        outs = [a.clone() for a in runner.decode_sample(**kw, eager=eager).arrs]
        runs.append((outs, _device_state(runner)))
    if runner.device.type == "cuda":
        torch.cuda.synchronize()
    (g_out, g_state), (e_out, e_state) = runs
    for name, a, b in zip(("tokens", "logprobs", "top_vals", "top_ids"), g_out, e_out):
        if not torch.equal(a, b):
            raise RuntimeError(f"grammar: single-step graph and eager runs differ in {name}")
    for i, (a, b) in enumerate(zip(g_state, e_state)):
        a, b = (a[:-1], b[:-1]) if i == len(g_state) - 1 else (a[:, 1:], b[:, 1:])
        if not torch.equal(a, b):
            raise RuntimeError(f"grammar: single-step graph and eager runs differ in device "
                               f"state {i}")
    return g_out[0].cpu().tolist()


def step_replay_ms(runner, kw) -> float:
    """Device time of one single step as a graph replay: the median of 5
    CUDA-event timings after one warm replay."""
    import torch

    runner.decode_sample(**kw)
    times = []
    for _ in range(5):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        runner.decode_sample(**kw)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def grammar_timing(engine, card_line: str, tag: str) -> dict:
    """On a runner of its own (the engine's weights and KV page format), at
    the burst's row lengths: the masked single step and the masked tree
    verify pass (S1 4 and 7) as graph replays bit-identical to op-by-op
    runs, with real schema masks (the tree's node tokens OR-ed in, so that
    drafts can be accepted); then on the card each replay's device time
    against its unmasked twin and a dense substep."""
    import dataclasses

    import numpy as np

    from dynamo_tpu_torch.engine.grammar import build_compiler, mask_words, pack_token_ids
    from dynamo_tpu_torch.engine.runner import LocalRunner

    cuda = engine.runner.device.type == "cuda"
    args = dataclasses.replace(engine.args, num_kv_blocks=640, spec_tokens=SPEC_TOKENS,
                               spec_fused=True)
    runner = LocalRunner(args, params=engine.runner.params)
    runner.start()
    V = runner.cfg.vocab_size
    g = build_compiler(None, V).compile(GRAMMAR_RF)
    eos_bits = pack_token_ids([257], V)
    B = len(BURST_HIST)
    states = grammar_states(g, B)
    row_masks = np.stack([g.mask(st, eos_bits) for st in states])
    out = {"mask_bytes_step": row_masks.nbytes}
    rows = verify_rows(runner, SPEC_TOKENS + 1)
    z = np.zeros((B,), np.int32)
    temps = np.zeros((B,), np.float32)
    temps[[3, 6]] = 0.7
    step = dict(mode="simple", tokens=np.asarray(rows["first"], np.int32),
                positions=rows["lens"].astype(np.int32), tables=rows["tables"],
                active=np.ones((B,), bool), temps=temps,
                seeds=np.arange(1000, 1000 + B, dtype=np.int32), steps=np.ones((B,), np.int32),
                tks=z, tps=np.ones((B,), np.float32), freqs=np.zeros((B,), np.float32),
                press=np.zeros((B,), np.float32), pen=np.full((B, 1), -1, np.int32),
                fold_slots=np.arange(B, dtype=np.int32), top_n=GRAMMAR_TOP, masks=row_masks)
    toks = step_graph_vs_eager(runner, step)
    legal = [g.advance(st, t) is not None or (t == 257 and g.is_terminal(st))
             for st, t in zip(states, toks)]
    if not all(legal):
        raise RuntimeError(f"{tag}: the masked step sampled an illegal token: {toks}")
    log(f"{tag}: masked single step, 8 rows at the burst's lengths: graph replay bit-identical "
        f"to op by op, every token legal ({card_line})")
    step_graph_vs_eager(runner, dict(step, masks=None))
    log(f"{tag}: unmasked single step (every K=1 plan without a grammar row): graph replay "
        f"bit-identical to op by op ({card_line})")
    if cuda:
        out["step_masked_ms"] = step_replay_ms(runner, step)
        out["step_unmasked_ms"] = step_replay_ms(runner, dict(step, masks=None))
    for S1 in (SPEC_TOKENS + 1, 2 * SPEC_TOKENS + 1):
        kw = verify_inputs(runner, S1, "tree", rows=rows if S1 == SPEC_TOKENS + 1 else None)
        masks = np.repeat(row_masks[:, None, :], S1, axis=1)
        for b in range(B):
            for t in kw["tokens"][b]:
                masks[b, :, t >> 5] |= np.uint32(1 << (int(t) & 31))
        kw["masks"] = masks
        out[f"mask_bytes_verify_S1_{S1}"] = masks.nbytes
        n_emit = verify_graph_vs_eager(runner, kw)
        log(f"{tag}: masked tree verify pass, S1={S1}: graph replay bit-identical to op by op, "
            f"n_emit {n_emit} ({card_line})")
        if cuda:
            out[f"tree_masked_S1_{S1}_ms"] = verify_replay_ms(runner, kw)
            out[f"tree_unmasked_S1_{S1}_ms"] = verify_replay_ms(runner, dict(kw, masks=None))
    if cuda:
        kw8 = dict(K=8, mode="greedy", tokens=step["tokens"], chain=None,
                   positions=step["positions"], tables=step["tables"],
                   active=step["active"], temps=np.zeros((B,), np.float32), seeds=z, steps0=z,
                   tks=z, tps=step["tps"], freqs=step["freqs"], press=step["press"],
                   pen=step["pen"], top_n=0)
        out["dense_substep_ms"] = replay_ms(runner, kw8)
        log(f"{tag}: device ms per replay: masked step {out['step_masked_ms']:.3f} / unmasked "
            f"{out['step_unmasked_ms']:.3f}; masked tree S1=4 {out['tree_masked_S1_4_ms']:.3f} / "
            f"unmasked {out['tree_unmasked_S1_4_ms']:.3f}; S1=7 {out['tree_masked_S1_7_ms']:.3f}"
            f" / {out['tree_unmasked_S1_7_ms']:.3f}; a dense substep (K=8 window / 8) "
            f"{out['dense_substep_ms']:.3f}; mask bytes uploaded per step "
            f"{out['mask_bytes_step']}, per S1=4 / 7 pass {out['mask_bytes_verify_S1_4']} / "
            f"{out['mask_bytes_verify_S1_7']} ({card_line})")
    runner.stop()
    return out


async def grammar_phase(card_line: str, preset: str = "llama-8b", device: str = "cuda",
                        dtype: str = "bfloat16", quant: str = "none", kv_quant: str = "none",
                        model=None):
    """Phase 12a: the burst's 8 prompts as chat completions with
    GRAMMAR_RF (max_tokens GRAMMAR_TOKENS, top-8 logprobs, seeds 1000-1007,
    rows 3 and 6 at temperature 0.7) through ``run``'s pipeline with
    ``--spec-tokens 3 --spec-ngram 1 --spec-tree-width 2`` (spec_gate 0,
    unpipelined, the scheduler held while the 8 queue), in turn dense
    (spec_tokens 0), tree and dense again. Every response
    finishes stop and validates; every token is legal under the FSM; the
    repeat equals the first dense burst bit for bit; a tree greedy stream
    leaves the dense one only where the two legal tokens' logprobs (each
    from its own pass) are within SPEC_GAP_TOL; attention launches 32 × (single
    steps + verify forwards), int8 calls by ``int8_expected`` over those
    forwards, no eager window, step or verify pass on the card. Then
    ``grammar_timing``. The bf16 run also embeds EMBED_CUTS in process
    (phase 12b's reference). ``model``: a ModelConfig in place of the
    preset's (``cut_config``)."""
    import numpy as np
    import torch

    from dynamo_tpu_torch.engine.grammar import build_compiler
    from dynamo_tpu_torch.llm.protocols import ChatCompletionRequest
    from dynamo_tpu_torch.run.__main__ import parse_args
    from dynamo_tpu_torch.runtime.engine import Context

    cuda = device == "cuda"
    tag = f"grammar[{'int8' if quant == 'int8' else dtype} weights, {kv_quant} KV]"
    args = parse_args(["--in", "batch:-", "--preset", preset, "--dtype", dtype,
                       "--device", device, *ENGINE_ARGV, "--spec-tokens", str(SPEC_TOKENS),
                       "--spec-ngram", str(SPEC_NGRAM), "--spec-tree-width", "2"])
    t0 = time.perf_counter()
    pipe = await local_pipeline(args, quant=quant, kv_quant=kv_quant, model=model)
    engine, runner = pipe.engine, pipe.engine.runner
    cfg, L = engine.cfg, engine.cfg.num_layers
    engine.set_spec(spec_gate=0.0)
    engine.args.pipeline_depth = 0
    log(f"{tag}: {cfg.name} ({L} layers) pipeline up in {time.perf_counter() - t0:.1f}s")
    result: dict = {}
    g = runner.graphs
    if g is not None:
        pool0, cap0 = g.pool_bytes(), g.capture_s
        n_steps = runner.warm_steps(("greedy", "simple"), (GRAMMAR_TOP,), masked=(True,))
        n_verify = runner.warm_spec(("greedy", "simple"), (GRAMMAR_TOP,), grammar=True)
        masked_verify = sum(1 for k in g.shapes if k[0] == "verify" and k[-1])
        result["graphs"] = {"masked_steps": n_steps, "verify": n_verify,
                            "masked_verify": masked_verify, "capture_s": g.capture_s - cap0,
                            "pool_bytes_added": g.pool_bytes() - pool0}
        log(f"{tag}: {n_steps} masked step graphs and {n_verify} verify graphs "
            f"({masked_verify} masked) captured in {g.capture_s - cap0:.2f}s, graph pool "
            f"+{(g.pool_bytes() - pool0) / 2**20:.1f} MiB to {g.pool_bytes() / 2**20:.1f} MiB "
            f"({card_line})")
    # Grammar compile: cold (the compiler over the vocabulary, then the
    # schema's DFA) and cached.
    t1 = time.perf_counter()
    engine._compile_grammar(GRAMMAR_RF)
    t2 = time.perf_counter()
    engine._compile_grammar(json.loads(json.dumps(GRAMMAR_RF)))
    result["compile_s"] = {"cold": t2 - t1, "cached": time.perf_counter() - t2}
    log(f"{tag}: grammar compile cold {result['compile_s']['cold'] * 1e3:.2f} ms, cached "
        f"{result['compile_s']['cached'] * 1e3:.3f} ms (host CPU beside {card_line})")
    fsm = build_compiler(None, cfg.vocab_size).compile(GRAMMAR_RF)
    prompts = burst_prompts()
    greedy_rows = [i for i, t in enumerate(BURST_TEMPS) if t == 0.0]
    eos = set(pipe.card.eos_token_ids)

    async def one(i):
        req = ChatCompletionRequest.parse(grammar_chat(i, prompts, pipe.card.name))
        gen = None
        async for g_, _chunk in pipe.run(req, Context()):
            gen = g_
        body = gen.final_response()
        return {"tokens": list(gen.lp_tokens), "logprobs": list(gen.lp_values),
                "tops": list(gen.lp_tops), "body": body,
                "view": choice_view("chat", body["choices"][0])}

    async def burst(label):
        engine.clear_kv_blocks()
        steps0 = engine.total_decode_steps
        ver0 = (runner.verify_passes, runner.verify_forwards, runner.verify_calls)
        eager0 = (runner.eager_windows, runner.eager_verifies, runner.eager_steps)
        spec0 = (engine.total_spec_tree_passes, engine.total_spec_proposed,
                 engine.total_spec_accepted)
        mask0, gen0 = engine.total_grammar_mask_s, engine.total_generated
        zero_counts()
        entered, gate = threading.Event(), threading.Event()

        def hold():
            entered.set()
            gate.wait(120)

        held = asyncio.ensure_future(engine.run_on_engine_thread(hold))
        while not entered.is_set():
            await asyncio.sleep(0.001)
        tasks = [asyncio.ensure_future(one(i)) for i in range(len(prompts))]
        deadline = time.perf_counter() + 60
        while engine.metrics().worker.num_requests_waiting < len(prompts):
            if time.perf_counter() > deadline or any(t.done() for t in tasks):
                gate.set()
                break
            await asyncio.sleep(0.001)
        t1 = time.perf_counter()
        gate.set()
        await held
        outs = await asyncio.gather(*tasks)
        wall = time.perf_counter() - t1
        while engine.busy():
            await asyncio.sleep(0.001)
        launches = int8_counts()
        substeps = engine.total_decode_steps - steps0
        passes = runner.verify_passes - ver0[0]
        forwards = runner.verify_forwards - ver0[1]
        vcalls = tuple(b - a for a, b in zip(ver0[2], runner.verify_calls))
        eager = tuple(b - a for a, b in zip(eager0, (runner.eager_windows, runner.eager_verifies,
                                                      runner.eager_steps)))
        tokens = engine.total_generated - gen0
        prompt_lens = [o["body"]["usage"]["prompt_tokens"] for o in outs]
        for i, o in enumerate(outs):
            if o["view"]["finish"] != "stop":
                raise RuntimeError(f"{tag}[{label}] request {i}: finish {o['view']['finish']!r} "
                                   f"after {len(o['tokens'])} tokens: {o['view']['text']!r}")
            grammar_valid(o["view"]["text"])
            fsm_legal(fsm, o["tokens"], eos)
            if not all(np.isfinite(lp) and lp <= 0.0 for lp in o["logprobs"]):
                raise RuntimeError(f"{tag}[{label}] request {i}: bad logprobs")
        per_fwd = verify_per_forward(L, cuda, quant == "int8")
        if launches[0] != per_fwd[0] * (substeps + forwards):
            raise RuntimeError(f"{tag}[{label}]: paged_attention launches {launches[0]} != "
                               f"{L} x (single steps {substeps} + verify forwards {forwards})")
        if tuple(vcalls) != tuple(n * forwards for n in per_fwd):
            raise RuntimeError(f"{tag}[{label}]: verify passes made {vcalls} kernel calls for "
                               f"{forwards} forwards")
        want_i8 = (0, 0, 0)
        if cuda and quant == "int8":
            k, p, w = int8_expected(cfg, prompt_lens, substeps)
            want_i8 = (k, p, w + per_fwd[4] * forwards)
        if launches[1:] != want_i8:
            raise RuntimeError(f"{tag}[{label}]: int8_matmul launches (kernel, prefill route, "
                               f"wide entry) {launches[1:]} != {want_i8}")
        if cuda and eager != (0, 0, 0):
            raise RuntimeError(f"{tag}[{label}]: {eager} windows, verify passes and single steps "
                               "ran eagerly on the card")
        if label.startswith("tree") and passes == 0:
            raise RuntimeError(f"{tag}[{label}]: no verify pass was dispatched")
        tree_passes = engine.total_spec_tree_passes - spec0[0]
        if passes != tree_passes:
            raise RuntimeError(f"{tag}[{label}]: {passes - tree_passes} constrained verify "
                               "passes were not tree passes")
        st = {"wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
              "single_steps": substeps, "verify_passes": passes, "verify_forwards": forwards,
              "attention_launches": launches[0], "int8_launches": launches[1],
              "int8_prefill_launches": launches[2], "int8_wide_launches": launches[3],
              "verify_attention_launches": vcalls[0],
              "mask_s": engine.total_grammar_mask_s - mask0,
              "accepted": engine.total_spec_accepted - spec0[2],
              "proposed": engine.total_spec_proposed - spec0[1],
              "completion_tokens": [len(o["tokens"]) for o in outs]}
        log(f"{tag}[{label}]: 8 constrained chats, {tokens} tokens in {wall:.3f}s → "
            f"{st['tokens_per_s']:.1f} tokens/s; {substeps} single steps, {passes} tree verify "
            f"passes ({st['accepted']}/{st['proposed']} drafts accepted); completions "
            f"{st['completion_tokens']} tokens, all stop, valid and FSM-legal; "
            f"engine_grammar_mask_seconds +{st['mask_s'] * 1e3:.2f} ms ({card_line})")
        log(f"{tag}[{label}]: paged_attention launches {launches[0]} = {L} x ({substeps} + "
            f"{forwards}); int8_matmul {launches[1]} on the kernel, {launches[2]} on the prefill "
            f"route")
        return outs, st

    engine.set_spec(spec_tokens=0)
    dense, result["dense"] = await burst("dense")
    engine.set_spec(spec_tokens=SPEC_TOKENS, **SPEC_TREE)
    tree_outs, result["tree"] = await burst("tree")
    gaps = tree_vs_dense_gaps(dense, tree_outs, greedy_rows, tag)
    result["tree"]["vs_dense"] = {"divergences": len(gaps), "gaps": gaps}
    log(f"{tag}: {len(greedy_rows)} greedy tree streams against dense: {len(gaps)} leave it, "
        f"each where the two legal tokens' logprobs are under {SPEC_GAP_TOL} nats apart "
        f"(gaps {[round(x, 4) for x in gaps]})")
    engine.set_spec(spec_tokens=0)
    again, result["dense_repeat"] = await burst("dense repeat")
    for i, (a, b) in enumerate(zip(dense, again)):
        if (a["tokens"], a["logprobs"], a["tops"]) != (b["tokens"], b["logprobs"], b["tops"]):
            raise RuntimeError(f"{tag}: the dense burst's repeat gave another stream {i}")
    log(f"{tag}: the dense burst again: all 8 constrained streams identical bit for bit")
    result["timing"] = grammar_timing(engine, card_line, tag)
    if g is not None:
        result["graph_pool_bytes"] = g.pool_bytes()
    reference = {"chats": {i: dense[i]["view"] for i in GRAMMAR_HTTP}}
    if quant == "none":
        from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer

        tok = ByteTokenizer()
        reference["embed_ids"] = [tok.encode(prompts[i][:n]) for i, n in EMBED_CUTS]
        vecs, times = [], []
        for ids in reference["embed_ids"]:
            t1 = time.perf_counter()
            vecs.append(await engine.embed(ids))
            times.append(time.perf_counter() - t1)
        for v in vecs:
            if len(v) != cfg.hidden_size or not all(np.isfinite(v)):
                raise RuntimeError(f"{tag}: embedding of {len(v)} values, or not finite")
        dist = embed_against_f32(cfg, runner.params, reference["embed_ids"], vecs,
                                 engine.args.max_prefill_tokens, engine.args.block_size, tag)
        reference["embeddings"] = vecs
        result["embed_ms"] = [t * 1e3 for t in times]
        result["embed_f32"] = dist
        log(f"{tag}: in-process engine.embed of {[len(x) for x in reference['embed_ids']]} "
            f"tokens: {[round(t * 1e3, 2) for t in times]} ms ({card_line})")
        log(f"{tag}: relative L2 distance to the float32 reference "
            f"{[f'{e:.4g}' for e in dist['rel_err']]} (< {EMBED_REL_TOL}); the reference "
            f"without its causal mask {[f'{e:.4g}' for e in dist['no_causal_mask']]}, the "
            f"vector averaged over its padded length {[f'{e:.4g}' for e in dist['padded_mean']]}"
            f" ({card_line})")
    await engine.stop()
    del pipe, engine, runner
    if cuda:
        torch.cuda.empty_cache()
    return result, reference


def grammar_http_phase(card_line: str, reference: dict, preset: str = "llama-8b",
                       device: str = "cuda", dtype: str = "bfloat16",
                       model_path: str | None = None) -> dict:
    """Phase 12b: the store, one ``python -m dynamo_tpu_torch.worker`` with
    the main path's engine arguments (seed 0: 12a's weights) and a kv-mode
    frontend. Two schema chats (GRAMMAR_HTTP: one streamed, one aggregate)
    equal to 12a's dense responses token text for token text and logprob
    for logprob; a json_object chat; an unsupported schema's typed 400; a
    /v1/responses request with text.format; /v1/embeddings with EMBED_CUTS
    in one request, each vector bit-equal to the in-process engine.embed of
    the same ids, and the same request again giving the same bytes. The
    worker's launches (SIGUSR1) are held to layers × its single steps; every
    process exits 0 on SIGTERM. With ``model_path`` the worker serves that
    checkpoint (12a's weights when 12a ran ``cut_config`` of it)."""
    cfg, weights = model_source(preset, model_path)
    procs: list[Proc] = []
    store_port = _free_port()
    store_url = f"tcp://127.0.0.1:{store_port}"
    try:
        store = Proc("grammar-store", ["dynamo_tpu_torch.runtime.store_server", "--host",
                                       "127.0.0.1", "--port", str(store_port)])
        procs.append(store)
        store.wait_for(r"store server: tcp://", 60)
        worker = Proc("grammar-worker", [
            "dynamo_tpu_torch.worker", "--store-url", store_url, *weights,
            "--dtype", dtype, "--device", device, *ENGINE_ARGV])
        procs.append(worker)
        m, secs = worker.wait_for(r"serving .* \((\d+) window graphs captured in ([0-9.]+)s, "
                                  r"(\d+) single-step graphs in ([0-9.]+)s", 600)
        log(f"grammar-http: worker registered {secs:.2f}s after launch, {m.group(1)} window and "
            f"{m.group(3)} single-step graphs (unmasked and masked) captured ({card_line})")
        fe = Proc("grammar-frontend", ["dynamo_tpu_torch.frontend", "--store-url", store_url,
                                       "--host", "127.0.0.1", "--port", "0",
                                       "--router-mode", "kv"])
        procs.append(fe)
        port = int(fe.wait_for(r"frontend: http://127\.0\.0\.1:(\d+)", 120)[0].group(1))
        result = asyncio.run(_drive_grammar_http(port, cfg.name, reference, card_line))
        counters = usr1_counters(worker)
        want = counters["num_layers"] * (counters["decode_substeps"] + counters["spec_forwards"])
        if counters["paged_attention_launches"] != (want if device == "cuda" else 0):
            raise RuntimeError(f"grammar-http: worker attention launches "
                               f"{counters['paged_attention_launches']} != {want}")
        if device == "cuda" and (counters["eager_windows"] or counters["eager_steps"]):
            raise RuntimeError(f"grammar-http: eager dispatches on the card: {counters}")
        log(f"grammar-http: worker paged_attention launches {counters['paged_attention_launches']}"
            f" = {counters['num_layers']} x {counters['decode_substeps']} single steps (0 on the "
            f"CPU), {counters['grammar_seqs']} constrained requests, mask seconds "
            f"{counters['grammar_mask_s']}")
        rcs = {p.name: p.stop() for p in [fe, worker, store]}
        if any(rcs.values()):
            raise RuntimeError(f"grammar-http: processes did not exit 0 on SIGTERM: {rcs}")
        log(f"grammar-http: every process exited 0 on SIGTERM ({rcs})")
        result.update(counters=counters, exit_codes=rcs, launch_to_registered_s=secs)
        return result
    finally:
        for p in procs:
            p.kill()


async def _drive_grammar_http(port: int, model: str, reference: dict, card_line: str) -> dict:
    prompts = burst_prompts()
    out: dict = {}
    await _wait_listed(port, model)
    # The two schema chats: streamed (GRAMMAR_HTTP[0]) and aggregate.
    for i, stream in zip(GRAMMAR_HTTP, (True, False)):
        ref = reference["chats"][i]
        status, _h, pieces, t0 = await http_request(
            port, "/v1/chat/completions", grammar_chat(i, prompts, model, stream))
        if status != 200:
            raise RuntimeError(f"grammar-http: chat {i} status {status}: {pieces[:1]}")
        if stream:
            events = sse_payloads(pieces)
            if not events or events[-1][1] != "[DONE]":
                raise RuntimeError(f"grammar-http: stream {i} did not end in [DONE]")
            text, lps, toks, finish = [], [], [], None
            for _t, data in events[:-1]:
                ch = json.loads(data)["choices"]
                if not ch:
                    continue
                ch = ch[0]
                text.append((ch.get("delta") or {}).get("content") or "")
                for e in ((ch.get("logprobs") or {}).get("content") or ()):
                    lps.append(e["logprob"])
                    toks.append(e["token"])
                finish = ch.get("finish_reason") or finish
            got = {"text": "".join(text), "finish": finish, "logprobs": lps, "lp_tokens": toks}
            if ref["lp_tokens"] and ref["lp_tokens"][-1] == "" and len(toks) + 1 == len(
                    ref["lp_tokens"]):
                # A chat stream's finish chunk carries no logprobs entry for
                # the EOS token (empty text), as in the JAX package; the
                # aggregate body lists it.
                ref = dict(ref, logprobs=ref["logprobs"][:-1], lp_tokens=ref["lp_tokens"][:-1])
        else:
            got = choice_view("chat", json.loads(b"".join(p for _, p in pieces))["choices"][0])
        if got != ref:
            bad = {k: (got[k], ref[k]) for k in ref if got.get(k) != ref[k]}
            raise RuntimeError(f"grammar-http: chat {i} ({'stream' if stream else 'aggregate'}) "
                               f"differs from 12a's dense response in {sorted(bad)}: "
                               f"{str(bad)[:600]}")
        grammar_valid(got["text"])
        out[f"chat_{i}_latency_s"] = pieces[-1][0] - t0
        log(f"grammar-http: chat {i} ({'SSE' if stream else 'aggregate'}): {len(got['logprobs'])} "
            f"token texts and logprobs equal 12a's dense response bit for bit, finish "
            f"{got['finish']}, valid")
    body = {"model": model, "messages": [{"role": "user", "content": prompts[0]}],
            "max_tokens": 48, "temperature": 0, "seed": 5,
            "response_format": {"type": "json_object"}}
    status, _h, pieces, _t = await http_request(port, "/v1/chat/completions", body)
    choice = json.loads(b"".join(p for _, p in pieces))["choices"][0] if status == 200 else {}
    if status != 200 or choice.get("finish_reason") not in ("stop", "length"):
        raise RuntimeError(f"grammar-http: json_object chat: status {status}, {choice}")
    log(f"grammar-http: json_object chat 200, finish {choice['finish_reason']}: "
        f"{choice['message']['content'][:60]!r}")
    bad = dict(body, response_format={"type": "json_schema", "json_schema": {
        "name": "bad", "schema": {"type": "object", "properties": {"a": {"type": "zzz"}}}}})
    status, _h, pieces, _t = await http_request(port, "/v1/chat/completions", bad)
    err = json.loads(b"".join(p for _, p in pieces)).get("error") or {}
    if status != 400 or err.get("type") != "invalid_request_error" \
            or "response_format" not in err.get("message", ""):
        raise RuntimeError(f"grammar-http: unsupported schema got {status} {err}")
    log(f"grammar-http: unsupported schema → 400 {err['type']}: {err['message'][:80]!r}")
    status, _h, pieces, _t = await http_request(port, "/v1/responses", {
        "model": model, "input": prompts[1], "max_output_tokens": GRAMMAR_TOKENS,
        "temperature": 0, "seed": 9,
        "text": {"format": {"type": "json_schema", "name": "record", "schema": GRAMMAR_SCHEMA}}})
    resp = json.loads(b"".join(p for _, p in pieces))
    if status != 200 or resp.get("status") != "completed":
        raise RuntimeError(f"grammar-http: /v1/responses status {status}: {str(resp)[:200]}")
    rtext = "".join(c["text"] for item in resp["output"] for c in item.get("content", [])
                    if c.get("type") == "output_text")
    grammar_valid(rtext)
    log(f"grammar-http: /v1/responses text.format 200, completed, valid: {rtext!r}")
    inputs = [list(ids) for ids in reference["embed_ids"]]
    bodies = []
    for rep in range(2):
        t0 = time.perf_counter()
        status, _h, pieces, _t = await http_request(port, "/v1/embeddings",
                                                    {"model": model, "input": inputs})
        secs = time.perf_counter() - t0
        raw = b"".join(p for _, p in pieces)
        if status != 200:
            raise RuntimeError(f"grammar-http: /v1/embeddings status {status}: {raw[:200]!r}")
        data = json.loads(raw)["data"]
        bodies.append(json.dumps([d["embedding"] for d in data]))
        for d, want in zip(data, reference["embeddings"]):
            if d["embedding"] != want:
                diff = max(abs(a - b) for a, b in zip(d["embedding"], want))
                raise RuntimeError(f"grammar-http: embedding {d['index']} differs from the "
                                   f"in-process engine.embed (max |diff| {diff:.3g})")
        if len(data) != len(inputs):
            raise RuntimeError(f"grammar-http: {len(data)} embeddings for {len(inputs)} inputs")
        ntok = sum(len(x) for x in inputs)
        out[f"embed_request_{rep}_ms"] = secs * 1e3
        out["embed_tokens_per_s"] = ntok / secs
        log(f"grammar-http: /v1/embeddings, {len(inputs)} inputs ({ntok} tokens) → 200, "
            f"{len(data)} vectors of {len(data[0]['embedding'])} floats, each bit-equal to the "
            f"in-process engine.embed, in {secs * 1e3:.1f} ms ({ntok / secs:.0f} tokens/s) "
            f"({card_line})")
    if bodies[0] != bodies[1]:
        raise RuntimeError("grammar-http: the same /v1/embeddings request gave other bytes")
    log("grammar-http: the same embeddings request again: the same bytes")
    return out


def grammar_lift_phase(card_line: str, vocab: int = 128_256, n_bpe: int | None = None) -> dict:
    """Phase 12c (host only): a Llama-3.1-shaped tokenizer.json of
    ``vocab`` ids (phase 9's recipe, ``write_llama3_tokenizer``) under
    build/grammar_tokenizer/, the grammar compiler built over it
    (``build_compiler``: every id decoded to its bytes) and the schema's
    first GRAMMAR_LIFT_STATES states lifted along the smallest legal token,
    each lift a walk of the whole vocabulary, as on a scheduler thread."""

    from dynamo_tpu_torch.engine.grammar import build_compiler

    path = os.path.join(HERE, "build", "grammar_tokenizer")
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    try:
        n_bpe = n_bpe if n_bpe is not None else vocab - 256
        t0 = time.perf_counter()
        write_llama3_tokenizer(path, n_bpe)
        t1 = time.perf_counter()
        comp = build_compiler({"type": "hf", "path": path}, vocab)
        t2 = time.perf_counter()
        g = comp.compile(GRAMMAR_RF)
        t3 = time.perf_counter()
        st, lifted, seen = g.start, [], set()
        while len(lifted) < GRAMMAR_LIFT_STATES and st is not None and st not in seen:
            seen.add(st)
            t = time.perf_counter()
            legal = g.mask(st)
            lifted.append(time.perf_counter() - t)
            ids = [i for i in range(min(vocab, len(legal) * 32))
                   if legal[i >> 5] >> (i & 31) & 1]
            if not ids:
                break
            st = g.advance(st, ids[0])
        out = {"tokenizer_write_s": t1 - t0, "compiler_build_s": t2 - t1,
               "schema_compile_s": t3 - t2, "vocab_tokens": len(comp.vocab),
               "lifted_states": len(lifted), "lift_s_per_state": statistics.mean(lifted),
               "lift_s_max": max(lifted)}
        log(f"grammar-lift: compiler over a {vocab}-id tokenizer built in "
            f"{out['compiler_build_s']:.2f}s ({out['vocab_tokens']} text tokens), schema "
            f"compiled in {out['schema_compile_s'] * 1e3:.2f} ms, {len(lifted)} states lifted at "
            f"{out['lift_s_per_state'] * 1e3:.1f} ms each (max {out['lift_s_max'] * 1e3:.1f}) "
            f"(host CPU beside {card_line})")
        return out
    finally:
        shutil.rmtree(path, ignore_errors=True)


# -- phase 3b's tied head: the int8 embedding used transposed -------------------

# The tied head's cases: llama-3b's head at every decode bucket and verify
# row count up to 256 (bf16 x: the tied wgmma entry), llama-1b's at 8 rows,
# and llama-3b's with f32 x (the first tied entry, CUDA cores).
TIED_CASES = ([("llama-3b", M, "bfloat16") for M in (1, 8, 16, 32, 64, 128, 256)]
              + [("llama-1b", 8, "bfloat16"), ("llama-3b", 8, "float32")])


def tied_head_phase(device, card_line: str) -> list[dict]:
    """The kernel's tied-head entries (w = emb.T of an int8 [V, D]
    embedding) against their plain version at ``TIED_CASES`` (f32 logits):
    TOL_INT8, bit-identical repeats, the route each call takes (bf16 x the
    tied wgmma entry at every row count, f32 x the first tied entry), and
    kernel, plain, library (bf16 ``torch.matmul`` on the dequantized head),
    dequantize + ``torch.matmul`` (the prefill route, which took bf16 heads
    of more than 64 rows before the wgmma entry) and bound times."""
    import torch

    from dynamo_tpu_torch.ops import int8_matmul as im

    got = {tile: im.tied_blocks_per_sm(tile) for tile in im.TIED_ROW_TILES}
    if set(got.values()) != {im.TIED_BLOCKS_PER_SM}:
        raise RuntimeError(f"int8 tied wgmma entry: blocks per SM by row tile {got}, its plan "
                           f"assumes {im.TIED_BLOCKS_PER_SM}")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    results = []
    for i, (name, M, xdt) in enumerate(TIED_CASES):
        K, N = TIED_HEADS[name]
        x, wt, s = int8_tied_case(M, K, N, xdt, 700 + i, device)
        which = im.route(x, wt)
        if which != ("tied_wide" if xdt == "bfloat16" else "tied"):
            raise RuntimeError(f"tied {name} M={M} {xdt}: route {which!r}")
        t0 = im.tied_launches
        err = int8_check(x, wt, s, True, f"tied {name} M={M} {xdt}")
        if im.tied_launches != t0 + 2:
            raise RuntimeError(f"tied {name}: emb.T did not reach a tied-head entry")
        ms = time_ms(lambda: im.int8_matmul(x, wt, s, out_f32=True), flush)
        plain_ms = time_ms(lambda: im.int8_matmul_ref(x, wt, s, out_f32=True), flush)
        dequant_ms = time_ms(lambda: torch.matmul(x, wt.to(x.dtype)).float() * s, flush)
        wb = wt.to(x.dtype)
        lib_ms = time_ms(lambda: torch.matmul(x, wb), flush)
        del wb
        b_ms, b_by = int8_bound(M, K, N, x.element_size(), 4, 4, xdt)
        plan = im.tied_plan(M, N) if which == "tied_wide" else None
        r = {"case": f"tied_{name}_M{M}_{xdt}", "M": M, "K": K, "N": N, "route": which,
             "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
             "dequant_ms": dequant_ms, "bound_ms": b_ms, "bound_by": b_by, "plan": plan}
        log(f"int8 {r['case']} (emb [{N}, {K}] used as emb.T, {which}): max_abs_err={err:.3e} "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
            f"dequant_ms={dequant_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) plan={plan} "
            f"({card_line})")
        results.append(r)
        del x, wt, s
    del flush
    torch.cuda.empty_cache()
    return results


# -- phase 4d: a full-depth tied int8 model on a serving path -------------------

TIED_SEQS = 128                          # max_num_seqs: decode buckets 8, 32 and 128
TIED_SAMPLED = range(7, TIED_SEQS, 16)   # 8 rows at temperature 0.7, the rest greedy
TIED_TOKENS = 32
TIED_KV_BLOCKS = 2800                    # 128 rows of up to 256 + 32 tokens, and margin
TIED_WINDOW_LENS = (64, 128, 256)        # prompt tokens of the timing runner's rows


def tied_requests() -> list[dict]:
    """128 seeded completions: byte-token prompts of 64-256 tokens, 8 of
    them at temperature 0.7 and the rest greedy."""
    import numpy as np

    rng = np.random.default_rng(15)
    lens = rng.integers(64, 257, TIED_SEQS)
    return [{"prompt": "".join(chr(c) for c in rng.integers(32, 127, n)),
             "temperature": 0.7 if i in TIED_SAMPLED else 0.0, "seed": 3000 + i, "len": int(n)}
            for i, n in enumerate(lens)]


async def tied_phase(card_line: str, preset: str = "llama-3b", device: str = "cuda",
                     dtype: str = "bfloat16", max_tokens: int = TIED_TOKENS) -> dict:
    """Phase 4d: ``preset`` (a tied model: its logits are the int8 embedding
    used as emb.T) at its full depth, int8 weights made from seed 0 and
    quantized on the card, bf16 pages, in an engine of 128 sequences at
    depth 2, serving ``tied_requests`` at once, so that its decode runs
    buckets 8, 32 and 128 as it fills and drains. Holds: no eager window or
    step; the tied head launched once per forward (substeps + prefills) and
    the prefill route never; the layer products to ``int8_expected`` by
    bucket. Then, on a runner of its own: a bucket-128 window run op by op,
    its head's x (as it reached the head at the first substep) through the
    tied entry within TOL_INT8 of the plain version on the card; the same
    window as a graph replay bit-identical to op by op; at buckets 8, 32 and
    128 the replay's device ms per substep and one profiled replay by kernel
    family (the head's share); and bucket 128's graph with the head on the
    prefill route (dequantize + ``torch.matmul``, its route before the
    wgmma entry) beside it, captured alone each: replay ms and pool bytes.
    ``max_tokens`` per request (32 on the card). → the phase's numbers."""
    import numpy as np
    import torch

    from dynamo_tpu_torch.engine.config import EngineArgs
    from dynamo_tpu_torch.engine.graphs import WindowGraphs
    from dynamo_tpu_torch.engine.runner import LocalRunner
    from dynamo_tpu_torch.llm.protocols import CompletionRequest
    from dynamo_tpu_torch.ops import int8_matmul as im
    from dynamo_tpu_torch.run.__main__ import parse_args
    from dynamo_tpu_torch.runtime.engine import Context

    tag = "tied"
    cuda = device == "cuda"
    args = parse_args(["--in", "batch:-", "--preset", preset, "--dtype", dtype, "--device", device,
                       "--block-size", "16", "--num-kv-blocks", str(TIED_KV_BLOCKS),
                       "--max-num-seqs", str(TIED_SEQS), "--max-model-len", "2048",
                       "--decode-steps", "8"])
    t0 = time.perf_counter()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    pipe = await local_pipeline(args, quant="int8", start=False)
    engine, runner = pipe.engine, pipe.engine.runner
    cfg = engine.cfg
    L = cfg.num_layers
    reqs = tied_requests()

    async def one(r):
        req = CompletionRequest.parse({
            "model": pipe.card.name, "prompt": r["prompt"], "max_tokens": max_tokens,
            "temperature": r["temperature"], "seed": r["seed"], "ignore_eos": True,
            "logprobs": 0})
        gen = None
        async for g_, _chunk in pipe.run(req, Context()):
            gen = g_
        return {"tokens": list(gen.lp_tokens), "logprobs": list(gen.lp_values)}

    # Every request reaches the engine before its scheduler starts, so the
    # admission waves (and the buckets they fill) are the same on any host.
    zero_counts()
    tasks = await submit_then_start(engine, (one(r) for r in reqs))
    t1 = time.perf_counter()
    params = runner.params
    if not cfg.tie_embeddings or params["embed"].dtype != torch.int8:
        raise RuntimeError(f"{tag}: {cfg.name} does not tie an int8 head")
    log(f"{tag}: {cfg.name} ({L} layers) int8 engine of {TIED_SEQS} sequences up in "
        f"{t1 - t0:.1f}s (random weights from seed 0 quantized on the "
        f"{'card' if cuda else 'CPU'}), decode buckets {engine.args.decode_buckets}, "
        f"pipeline_depth {engine.args.effective_pipeline_depth}, {len(reqs)} requests "
        f"submitted before its scheduler started")
    outs = await asyncio.gather(*tasks)
    wall = time.perf_counter() - t1
    while engine.busy():
        await asyncio.sleep(0.001)
    counts = (*int8_counts(), im.tied_launches)
    by_bucket = dict(engine.decode_steps_by_bucket)
    substeps = sum(by_bucket.values())
    eager = (runner.eager_windows, runner.eager_steps)
    captured = (runner.graphs.captured, runner.graphs.capture_s) if runner.graphs else (0, 0.0)
    phase = _counters(engine)[1]
    for i, o in enumerate(outs):
        if len(o["tokens"]) != max_tokens or not all(
                np.isfinite(lp) and lp <= 0.0 for lp in o["logprobs"]) or not all(
                0 <= t < cfg.vocab_size for t in o["tokens"]):
            raise RuntimeError(f"{tag} request {i}: bad token/logprob stream")
    forwards = substeps + len(prefill_chunk_buckets([r["len"] for r in reqs]))
    want = ((L * substeps, *int8_expected(cfg, [r["len"] for r in reqs], substeps,
                                          buckets=by_bucket), forwards)
            if cuda else (0, 0, 0, 0, 0))
    if counts != want or substeps == 0:
        raise RuntimeError(f"{tag}: launches (attention, int8 kernel, int8 prefill route, int8 "
                           f"wide entry, tied head) {counts} != {want} for substeps by bucket "
                           f"{by_bucket} and {forwards - substeps} prefill chunks")
    if cuda and eager != (0, 0):
        raise RuntimeError(f"{tag}: {eager[0]} windows and {eager[1]} single steps ran eagerly")
    if cuda and not {32, TIED_SEQS} <= set(by_bucket):
        raise RuntimeError(f"{tag}: decode ran buckets {sorted(by_bucket)}, not 32 and "
                           f"{TIED_SEQS}")
    tokens = len(reqs) * max_tokens
    decode_s = sum(phase.get(k, 0.0) for k in DECODE_PHASES)
    st = {"model": cfg.name, "layers": L, "tokens_per_s": tokens / wall, "wall_s": wall,
          "substeps": substeps, "substeps_by_bucket": by_bucket, "forwards": forwards,
          "launches": counts, "host_ms_per_substep": decode_s / max(1, substeps) * 1e3,
          "prefill_s": phase.get("prefill_dispatch", 0.0), "graphs_captured": captured[0],
          "capture_s": captured[1],
          "graph_pool_bytes": runner.graphs.pool_bytes() if runner.graphs else 0,
          "max_mem_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0}
    log(f"{tag}: {len(reqs)} requests ({len(TIED_SAMPLED)} at temperature 0.7), {tokens} tokens "
        f"in {wall:.3f}s → {st['tokens_per_s']:.1f} tokens/s; decode substeps by bucket "
        f"{by_bucket}; host ms per substep {st['host_ms_per_substep']:.3f}; prefill "
        f"{st['prefill_s']:.2f}s of host time; {captured[0]} window graphs captured at first use "
        f"in {captured[1]:.2f}s, graph pool {st['graph_pool_bytes'] / 2**20:.1f} MiB; peak memory "
        f"{st['max_mem_gib']:.2f} GiB ({card_line})")
    log(f"{tag}: launches (attention, int8 kernel, int8 prefill route, int8 wide entry, tied "
        f"head) {counts}: the tied head once per forward ({substeps} substeps + "
        f"{forwards - substeps} prefill chunks), the layer products 7 x {L} per forward on "
        "their rows' routes")
    await engine.stop()
    del pipe, engine, runner

    if cuda:
        rargs = EngineArgs(model=cfg, block_size=16, num_kv_blocks=1400, max_num_seqs=TIED_SEQS,
                           max_model_len=2048, decode_steps=8, dtype=dtype, device="cuda",
                           quant="int8")
        trunner = LocalRunner(rargs, params=params)
        trunner.start()
        weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
        st["replay_ms_per_substep"], st["replay_profile"] = {}, {}
        for live in (100, 32, 6):
            B = rargs.bucket_decode(live)
            kw = dict(window_inputs(trunner, "simple", 80 + live, lens=TIED_WINDOW_LENS,
                                    live=live), top_n=0)
            if B == TIED_SEQS:
                # Record the (x, w, scale) of every tied-head call (emb.T).
                heads, real = [], im.int8_matmul

                def recording(x, w, scale, out_f32=False):
                    if not w.is_contiguous() and w.T.is_contiguous():
                        heads.append((x.detach().clone(), w, scale))
                    return real(x, w, scale, out_f32)

                state = _device_state(trunner)
                im.int8_matmul = recording
                try:
                    trunner.multi_decode(**kw, eager=True)
                finally:
                    im.int8_matmul = real
                _restore(trunner, state)
                if len(heads) != kw["K"] or heads[0][0].numel() != B * cfg.hidden_size:
                    raise RuntimeError(f"{tag}: {len(heads)} tied-head calls in a {kw['K']}-step "
                                       f"window of {B} rows")
                x, w, s = heads[0]
                x = x.reshape(-1, x.shape[-1])
                st["head_max_abs_err"] = int8_check(x, w, s, True, f"{tag} head at bucket {B}")
                log(f"{tag}: bucket {B}, first substep of an op-by-op window: the head's x "
                    f"[{x.shape[0]}, {x.shape[1]}] through the tied entry ({im.route(x, w)}) "
                    f"within TOL_INT8 of int8_matmul_ref, max |err| "
                    f"{st['head_max_abs_err']:.3e}, repeat bit-identical")
                del heads, x, w, s, state
                graph_vs_eager(trunner, kw)
                log(f"{tag}: bucket {B} ({live} live rows) window: graph replay bit-identical to "
                    f"op by op (tokens, logprobs, KV pages, chain)")
                kw128 = kw
            st["replay_ms_per_substep"][B] = replay_ms(trunner, kw)
            # Byte bound of a substep: every weight once, and each live row's
            # KV pages (k and v, every layer) over its context once.
            kv_bytes = sum(int(n) for n in kw["positions"][:live]) * rargs.kv_bytes_per_block() \
                // rargs.block_size
            st.setdefault("byte_bound_ms_per_substep", {})[B] = (
                (weight_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3)
            prof = profile_replay(trunner, kw, card_line, f"{cfg.name}, bucket {B}, {live} live "
                                                         "rows")
            head = prof["families"]["int8 tied head"]["ms"]
            st["replay_profile"][B] = prof
            log(f"{tag}: bucket {B}: {st['replay_ms_per_substep'][B]:.3f} ms device time per "
                f"substep as one graph replay, byte bound "
                f"{st['byte_bound_ms_per_substep'][B]:.3f} ms ({weight_bytes / 1e9:.3f} GB of "
                f"weights and the live rows' KV at 3.35 TB/s); the tied head {head:.3f} ms of "
                f"{prof['ms_per_substep']:.3f} profiled ({100 * head / prof['ms_per_substep']:.1f}%)"
                f" ({card_line})")
        # Bucket 128's window captured alone, the head on the tied entry and
        # on the prefill route (its route before the wgmma entry), in turns.
        real_route, alone = im.route, {}

        def prefill_head(x, w):
            which = real_route(x, w)
            return "prefill" if which == "tied_wide" else which

        for variant in ("tied_wide", "prefill", "prefill", "tied_wide"):
            trunner.graphs = WindowGraphs(trunner.device)
            im.route = prefill_head if variant == "prefill" else real_route
            try:
                ms = replay_ms(trunner, kw128)
            finally:
                im.route = real_route
            alone.setdefault(variant, []).append((ms, trunner.graphs.pool_bytes()))
        trunner.graphs = None
        st["bucket128_alone"] = {v: {"replay_ms": [m for m, _ in r], "pool_bytes": r[0][1]}
                                 for v, r in alone.items()}
        for v, r in st["bucket128_alone"].items():
            log(f"{tag}: bucket 128's window captured alone, head on {v}: replay "
                f"{' / '.join(f'{m:.3f}' for m in r['replay_ms'])} ms per substep, graph pool "
                f"{r['pool_bytes'] / 2**20:.1f} MiB ({card_line})")
        trunner.stop()
        del trunner, kw128
    del params
    if cuda:
        torch.cuda.empty_cache()
    return st


# -- phase 4e: a mixture-of-experts model on the main path ---------------------

MOE_LEAVES = ("w_router", "moe_gate", "moe_up", "moe_down")
MOE_SEQS = 128                       # the timing runner's max_num_seqs: buckets 8, 32 and 128
MOE_WINDOW_LENS = (64, 128, 256)     # prompt tokens of the timing runner's rows
MOE_PREFILL_ROWS = 1536              # a prefill chunk: the burst's longest prompt
# bf16 router logits are each within 2^-9 of their magnitude of the exact
# ones (under 0.008 below 4), so two of them cannot trade places across a
# gap of 0.02: rows whose reference k-th and (k+1)-th log-probabilities
# are closer than that are left out of the expert and output checks.
MOE_GAP = 0.02
# |port - float64 loop| <= atol + rtol * |loop| on the combined output. In
# bf16 the output is rounded once, and h and its weighted copy per element,
# over 8 experts x 1024 terms summed in f32: 0.0075 at most at moe-wide's
# widths on the CPU's bf16 products, against 0.02 here.
MOE_TOL = {"bfloat16": (0.02, 2.0 ** -7), "float32": (1e-4, 1e-4)}
MOE_FAMILIES = {"expert and router products": ("gemm", "nvjet", "gemv", "cutlass", "splitK",
                                               "xmma"),
                "router softmax": ("softmax",), "router sort": ("sort", "Sort", "radix"),
                "router scatter": ("scatter",), "copy": ("copy",)}


def moe_against_reference(x, lp, cfg, dtype: str) -> dict:
    """The port's ``_moe`` on ``x`` [T, D] (one layer's recorded input, on
    its device) against a float64 loop over each row's chosen experts on
    the host: for every row whose reference k-th and (k+1)-th
    log-probabilities are more than ``MOE_GAP`` apart, the same set of
    experts as the port's router chose and outputs within ``MOE_TOL``;
    raises otherwise. → rows checked and left out, max |error|."""
    import numpy as np

    from dynamo_tpu_torch.engine import model as M

    k = cfg.num_experts_per_token
    y = M._moe(x, lp, cfg).double().cpu().numpy()
    topi = M._moe_route(x, lp["w_router"], k)[2].cpu().numpy()
    xd = x.double().cpu().numpy()
    logits = xd @ lp["w_router"].double().cpu().numpy()
    atol, rtol = MOE_TOL[dtype]
    experts: dict[int, tuple] = {}
    checked, left_out, err = 0, 0, 0.0
    for t in range(xd.shape[0]):
        order = np.argsort(-logits[t], kind="stable")
        if logits[t, order[k - 1]] - logits[t, order[k]] <= MOE_GAP:
            left_out += 1
            continue
        idx = order[:k]
        if set(idx.tolist()) != set(topi[t].tolist()):
            raise RuntimeError(f"moe: row {t} routed to experts {sorted(topi[t].tolist())}, the "
                               f"float64 reference to {sorted(idx.tolist())}")
        w = np.exp(logits[t, idx] - logits[t, idx].max())
        w /= w.sum()
        ref = np.zeros(xd.shape[1])
        for e, wi in zip(idx.tolist(), w):
            if e not in experts:
                experts[e] = tuple(lp[n][e].double().cpu().numpy()
                                   for n in ("moe_gate", "moe_up", "moe_down"))
            gate, up, down = experts[e]
            g, u = xd[t] @ gate, xd[t] @ up
            ref += wi * (((g / (1 + np.exp(-g))) * u) @ down)
        diff = np.abs(y[t] - ref)
        if (diff > atol + rtol * np.abs(ref)).any():
            raise RuntimeError(f"moe: row {t} output off the float64 reference by "
                               f"{diff.max():.4g} (tolerance {atol} + {rtol:.4g} x |ref|)")
        checked += 1
        err = max(err, float(diff.max()))
    return {"rows_checked": checked, "rows_left_out": left_out, "max_abs_err": err}


def moe_bounds(cfg, routed: list[int], rows: int, elem: int) -> dict:
    """Byte bounds of one decode substep (every weight read once) at 3.35
    TB/s: the dense form's (every expert, as ``_moe`` computes) and the
    routed form's (only the ``routed[layer]`` experts that the rows chose),
    and the expert products' FLOPs per token, dense and routed."""
    d, E, k, L = cfg.hidden_size, cfg.num_experts, cfg.num_experts_per_token, cfg.num_layers
    ie = cfg.moe_intermediate_size or cfg.intermediate_size
    expert = 3 * d * ie
    dense = cfg.param_count() * elem
    routed_bytes = (cfg.active_param_count() - L * k * expert + sum(routed) * expert) * elem
    return {"dense_bytes": dense, "dense_bound_ms": dense / HBM_BYTES_PER_S * 1e3,
            "routed_rows": rows, "routed_experts_per_layer": routed,
            "routed_bytes": routed_bytes,
            "routed_bound_ms": routed_bytes / HBM_BYTES_PER_S * 1e3,
            "one_row_bound_ms": cfg.active_param_count() * elem / HBM_BYTES_PER_S * 1e3,
            "expert_gflop_per_token_dense": 2 * L * E * expert / 1e9,
            "expert_gflop_per_token_routed": 2 * L * k * expert / 1e9}


def moe_alone(params, cfg, rows: int, card_line: str, seed: int = 0) -> dict:
    """The MoE FFN of every layer on ``rows`` unit-scale rows, captured as
    one CUDA graph: device ms per layer (the median of 5 replays over the
    layers), the bound per layer (every expert's weights read once against
    the products' operations at the bf16 peak) and one profiled replay by
    family."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dynamo_tpu_torch.engine import model as M

    L, d, E = cfg.num_layers, cfg.hidden_size, cfg.num_experts
    layers = params["layers"]
    dtype = layers["moe_gate"].dtype
    lps = [{n: layers[n][i] for n in MOE_LEAVES} for i in range(L)]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((rows, d), generator=gen, device="cuda").to(dtype)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for lp in lps:
            M._moe(x, lp, cfg)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ys = [M._moe(x, lp, cfg) for lp in lps]
    graph.replay()
    times = []
    for _ in range(5):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    fam = {k: [0.0, 0.0] for k in [*MOE_FAMILIES, "other elementwise"]}
    for e in prof.key_averages():
        if e.self_device_time_total <= 0:
            continue
        name = next((f for f, pats in MOE_FAMILIES.items() if any(p in e.key for p in pats)),
                    "other elementwise")
        fam[name][0] += e.self_device_time_total / 1e3 / L
        fam[name][1] += e.count / L
    del graph, ys
    weights = sum(layers[n][0].numel() for n in MOE_LEAVES)
    elem = layers["moe_gate"].element_size()
    b_ms = max((weights + 2 * rows * d) * elem / HBM_BYTES_PER_S,
               2 * rows * weights / PEAK_OPS[str(dtype).replace("torch.", "")]) * 1e3
    ms = statistics.median(times) / L
    out = {"rows": rows, "ms_per_layer": ms, "bound_ms_per_layer": b_ms,
           "bound_by": "bytes" if (weights + 2 * rows * d) * elem / HBM_BYTES_PER_S
           >= 2 * rows * weights / PEAK_OPS[str(dtype).replace("torch.", "")] else "operations",
           "kernels_per_layer": sum(v[1] for v in fam.values()),
           "families_ms_per_layer": {k: v[0] for k, v in fam.items()}}
    log(f"moe alone: {rows} rows, {L} layers as one graph: {ms:.4f} ms per layer (bound "
        f"{b_ms:.4f}, {out['bound_by']}), {out['kernels_per_layer']:.0f} kernels per layer; "
        + ", ".join(f"{k} {v[0]:.4f}" for k, v in fam.items()) + f" ms per layer ({card_line})")
    return out


async def moe_phase(card_line: str, preset: str = "moe-wide", device: str = "cuda",
                    dtype: str = "bfloat16", max_tokens: int = BURST_TOKENS) -> dict:
    """Phase 4e: ``preset`` (a mixture-of-experts model) at its full depth
    through ``run``'s pipeline with the main path's engine arguments, bf16
    weights made from seed 0 on the card and bf16 pages, every window shape
    captured first; the burst at depth 2, then its greedy requests at
    depth 0 (the same streams). Holds: no eager window or step; attention
    launches L x substeps and no int8 launch; every token in the
    vocabulary and every logprob finite and <= 0. Then, on a runner of its
    own with 128 sequences: a bucket-8 window op by op with every layer's
    MoE input at its first substep recorded, one layer's through the port's
    ``_moe`` against the float64 loop (``moe_against_reference``); the
    routed byte bound from the experts the rows chose; on the card the
    same window as a graph replay bit-identical to op by op, no copy of an
    expert stack in a ``_moe`` call, replay device ms per substep and one
    profiled replay at buckets 8, 32 and 128, and the MoE alone
    (``moe_alone``) at those rows and a prefill chunk, with its share of
    each replay. ``max_tokens`` per request (64 on the card). → the
    phase's numbers."""
    import numpy as np
    import torch

    from dynamo_tpu_torch.engine import model as M
    from dynamo_tpu_torch.engine.config import EngineArgs
    from dynamo_tpu_torch.engine.runner import LocalRunner
    from dynamo_tpu_torch.llm.protocols import CompletionRequest
    from dynamo_tpu_torch.ops import int8_matmul as im
    from dynamo_tpu_torch.run.__main__ import build_pipeline, parse_args
    from dynamo_tpu_torch.runtime.engine import Context

    tag = "moe"
    cuda = device == "cuda"
    args = parse_args(["--in", "batch:-", "--preset", preset, "--dtype", dtype, "--device",
                       device, *ENGINE_ARGV])
    t0 = time.perf_counter()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    pipe = await build_pipeline(args)
    engine, runner = pipe.engine, pipe.engine.runner
    cfg, params = engine.cfg, runner.params
    if not cfg.num_experts or "moe_gate" not in params["layers"]:
        raise RuntimeError(f"{tag}: {cfg.name} is not a mixture-of-experts model")
    L, k = cfg.num_layers, cfg.num_experts_per_token
    g = runner.graphs
    n_warm = runner.warm_windows(("greedy", "simple"), (0,))
    log(f"{tag}: {cfg.name} ({L} layers, {cfg.num_experts} experts, top {k}, expert width "
        f"{cfg.moe_intermediate_size}) pipeline up in {time.perf_counter() - t0:.1f}s (random "
        f"{dtype} weights from seed 0 made on the {'card' if cuda else 'CPU'}), pipeline_depth "
        f"{engine.args.effective_pipeline_depth}; {n_warm} window graphs captured ahead of "
        f"traffic in {g.capture_s if g else 0.0:.2f}s ({card_line})")
    prompts = burst_prompts()

    async def one(i):
        req = CompletionRequest.parse({
            "model": pipe.card.name, "prompt": prompts[i], "max_tokens": max_tokens,
            "temperature": BURST_TEMPS[i], "seed": 1000 + i, "ignore_eos": True, "logprobs": 0})
        gen = None
        async for g_, _chunk in pipe.run(req, Context()):
            gen = g_
        return {"tokens": list(gen.lp_tokens), "logprobs": list(gen.lp_values)}

    async def burst(idx, label):
        """Requests ``idx`` at once; every count zeroed just before, read
        just after the engine has drained."""
        steps0, phases0 = _counters(engine)
        eager0 = (runner.eager_windows, runner.eager_steps)
        zero_counts()
        t1 = time.perf_counter()
        outs = await asyncio.gather(*(one(i) for i in idx))
        wall = time.perf_counter() - t1
        while engine.busy():
            await asyncio.sleep(0.001)
        counts = (*int8_counts(), im.tied_launches)
        steps1, phases1 = _counters(engine)
        substeps = steps1 - steps0
        phase = {key: v - phases0.get(key, 0.0) for key, v in phases1.items()}
        eager = (runner.eager_windows - eager0[0], runner.eager_steps - eager0[1])
        for i, o in zip(idx, outs):
            if len(o["tokens"]) != max_tokens or not all(
                    np.isfinite(lp) and lp <= 0.0 for lp in o["logprobs"]) or not all(
                    0 <= t < cfg.vocab_size for t in o["tokens"]):
                raise RuntimeError(f"{tag}[{label}] request {i}: bad token/logprob stream")
        want = (L * substeps if cuda else 0, 0, 0, 0, 0)
        if counts != want or substeps == 0:
            raise RuntimeError(f"{tag}[{label}]: launches (attention, int8 kernel, int8 prefill "
                               f"route, int8 wide entry, int8 tied head) {counts} != {want} for "
                               f"{substeps} substeps")
        if cuda and eager != (0, 0):
            raise RuntimeError(f"{tag}[{label}]: {eager[0]} windows and {eager[1]} single steps "
                               "ran eagerly")
        decode_s = sum(phase.get(key, 0.0) for key in DECODE_PHASES)
        st = {"requests": len(idx), "tokens_per_s": len(idx) * max_tokens / wall, "wall_s": wall,
              "substeps": substeps, "launches": counts,
              "host_ms_per_substep": decode_s / substeps * 1e3,
              "prefill_s": phase.get("prefill_dispatch", 0.0)}
        log(f"{tag}[{label}]: {len(idx)} requests, {len(idx) * max_tokens} tokens in {wall:.3f}s "
            f"→ {st['tokens_per_s']:.1f} tokens/s; {substeps} substeps, host ms per substep "
            f"{st['host_ms_per_substep']:.3f}; prefill {st['prefill_s']:.2f}s of host time; "
            f"launches (attention, int8 kernel, int8 prefill route, int8 wide entry, int8 tied "
            f"head) {counts} ({card_line})")
        return outs, st

    outs2, st = await burst(range(len(prompts)), "depth2")
    st.update({"model": cfg.name, "layers": L, "experts": cfg.num_experts, "top_k": k,
               "graphs": g.captured if g else 0, "capture_s": g.capture_s if g else 0.0,
               "graph_pool_bytes": g.pool_bytes() if g else 0,
               "max_mem_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0})
    engine.clear_kv_blocks()
    engine.args.pipeline_depth = 0
    greedy = [i for i, t in enumerate(BURST_TEMPS) if t == 0.0]
    outs0, st0 = await burst(greedy, "depth0")
    engine.args.pipeline_depth = 2
    for i, o in zip(greedy, outs0):
        if o != outs2[i]:
            raise RuntimeError(f"{tag} request {i}: greedy streams differ at depth 2 and 0")
    st["depth0"] = st0
    log(f"{tag}: the {len(greedy)} greedy streams identical at pipeline_depth 2 and 0; "
        f"{st['graphs']} window graphs, graph pool {st['graph_pool_bytes'] / 2**20:.1f} MiB, "
        f"peak memory {st['max_mem_gib']:.2f} GiB ({card_line})")
    await engine.stop()
    del pipe, engine, runner

    rargs = EngineArgs(model=cfg, block_size=16, num_kv_blocks=1400, max_num_seqs=MOE_SEQS,
                       max_model_len=2048, decode_steps=8, dtype=dtype, device=device)
    trunner = LocalRunner(rargs, params=params)
    trunner.start()
    kw = dict(window_inputs(trunner, "simple", 90, lens=MOE_WINDOW_LENS, live=6), top_n=0)
    B = rargs.bucket_decode(6)
    # The window op by op, every layer's MoE input at its first substep recorded.
    xs, real = [], M._moe

    def recording(x, lp, cfg_, tp=None):
        if len(xs) < L:
            xs.append(x.detach().reshape(-1, x.shape[-1]).clone())
        return real(x, lp, cfg_, tp)

    state = _device_state(trunner)
    M._moe = recording
    try:
        trunner.multi_decode(**kw, eager=True)
    finally:
        M._moe = real
    _restore(trunner, state)
    del state
    if len(xs) != L or xs[0].shape != (B, cfg.hidden_size):
        raise RuntimeError(f"{tag}: recorded {len(xs)} MoE inputs of shape "
                           f"{tuple(xs[0].shape) if xs else None} in a bucket-{B} window")
    mid = L // 2
    lp = {n: params["layers"][n][mid] for n in MOE_LEAVES}
    st["check"] = {"layer": mid, **moe_against_reference(xs[mid], lp, cfg, dtype)}
    log(f"{tag}: bucket {B}, first substep of an op-by-op window: layer {mid}'s MoE input "
        f"[{B}, {cfg.hidden_size}] through _moe against the float64 loop: "
        f"{st['check']['rows_checked']} rows with the same experts and within {MOE_TOL[dtype]}, "
        f"max |err| {st['check']['max_abs_err']:.3e}; {st['check']['rows_left_out']} rows left "
        f"out by the gap rule (k-th and (k+1)-th log-probabilities within {MOE_GAP})")
    routed = [len(set(M._moe_route(x[:6], params["layers"]["w_router"][i], k)[2].flatten()
                      .tolist())) for i, x in enumerate(xs)]
    st.update(moe_bounds(cfg, routed, 6, params["layers"]["moe_gate"].element_size()))
    log(f"{tag}: byte bound per substep: dense (every expert, as _moe reads them) "
        f"{st['dense_bytes'] / 1e9:.3f} GB, {st['dense_bound_ms']:.3f} ms; routed (the experts "
        f"6 live rows chose, {routed} of {cfg.num_experts} per layer) "
        f"{st['routed_bytes'] / 1e9:.3f} GB, {st['routed_bound_ms']:.3f} ms; one row "
        f"{st['one_row_bound_ms']:.3f} ms at 3.35 TB/s; expert products "
        f"{st['expert_gflop_per_token_dense']:.2f} GFLOP a token dense against "
        f"{st['expert_gflop_per_token_routed']:.2f} routed ({card_line})")
    if cuda:
        graph_vs_eager(trunner, kw)
        log(f"{tag}: bucket {B} (6 live rows) window: graph replay bit-identical to op by op "
            "(tokens, logprobs, KV pages, chain)")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        M._moe(xs[mid], lp, cfg)
        torch.cuda.synchronize()
        st["moe_call_peak_bytes"] = torch.cuda.max_memory_allocated() - base
        stack = lp["moe_gate"].numel() * lp["moe_gate"].element_size()
        if st["moe_call_peak_bytes"] >= stack // 4:
            raise RuntimeError(f"{tag}: a _moe call at {B} rows took "
                               f"{st['moe_call_peak_bytes'] / 2**20:.1f} MiB beside its inputs, "
                               f"against {stack / 2**20:.1f} MiB for one expert stack")
        log(f"{tag}: one _moe call at {B} rows allocates "
            f"{st['moe_call_peak_bytes'] / 2**20:.2f} MiB at its peak (an expert stack is "
            f"{stack / 2**20:.1f} MiB): no stack is copied")
        st["replay_ms_per_substep"], st["replay_profile"], st["alone"] = {}, {}, {}
        for live in (6, 32, 100):
            Bl = rargs.bucket_decode(live)
            kwl = kw if live == 6 else dict(window_inputs(trunner, "simple", 90 + live,
                                                          lens=MOE_WINDOW_LENS, live=live),
                                            top_n=0)
            st["replay_ms_per_substep"][Bl] = replay_ms(trunner, kwl)
            st["replay_profile"][Bl] = profile_replay(trunner, kwl, card_line,
                                                      f"{cfg.name}, bucket {Bl}, {live} live rows")
            st["alone"][Bl] = moe_alone(params, cfg, Bl, card_line, seed=Bl)
            share = L * st["alone"][Bl]["ms_per_layer"] / st["replay_ms_per_substep"][Bl]
            st["alone"][Bl]["share_of_replay"] = share
            log(f"{tag}: bucket {Bl}: {st['replay_ms_per_substep'][Bl]:.3f} ms device time per "
                f"substep as one graph replay; the MoE of {L} layers alone "
                f"{L * st['alone'][Bl]['ms_per_layer']:.3f} ms of it ({100 * share:.1f}%) "
                f"({card_line})")
        st["alone"]["prefill"] = moe_alone(params, cfg, MOE_PREFILL_ROWS, card_line, seed=1)
    trunner.stop()
    del trunner, params, xs
    if cuda:
        torch.cuda.empty_cache()
    return st


# -- phase 13: KV tiers (G2 host, G3 disk, G4 fleet) and peer prefix fetch ------

TIER_DIR = os.path.join(HERE, "build", "tiers")
TIER_HOST_BLOCKS = 512   # 13a's G2: holds every block of the burst
TIER_SMALL_HOST = 32     # a G2 too small for the burst: blocks spill to G3 / G4
TIER_OFFLOAD_PROBE = 64  # blocks per timed device→host copy (MAX_OFFLOAD_PER_STEP)


def tier_requests(model: str, max_tokens: int = BURST_TOKENS, prompts=None) -> list[dict]:
    """The burst as engine requests (byte tokens, seeds 1000-1007, the
    burst's temperatures, logprobs)."""
    prompts = burst_prompts() if prompts is None else prompts
    return [{"model": model, "token_ids": list(p.encode()),
             "sampling": {"temperature": BURST_TEMPS[i], "seed": 1000 + i, "logprobs": True},
             "stop": {"max_tokens": max_tokens, "ignore_eos": True}}
            for i, p in enumerate(prompts)]


def prompt_hashes(req: dict, bs: int) -> list[int]:
    """A request's full prompt blocks' chained hashes (the matchable ones)."""
    from dynamo_tpu_torch.tokens import compute_block_hashes

    ids = req["token_ids"]
    return compute_block_hashes(ids, bs)[: (len(ids) - 1) // bs]


def _tier_bytes(pool) -> int:
    return sum(int(a.nbytes) for pages in pool._pages.values() for a in pages)


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)
               if f.endswith(".npz"))


def _same_streams(tag: str, got: list, ref: list) -> None:
    """Token ids and logprobs bit for bit, request by request."""
    for i, (g, r) in enumerate(zip(got, ref)):
        if g["tokens"] != r["tokens"] or g["logprobs"] != r["logprobs"]:
            k = next((j for j, (a, b) in enumerate(zip(g["tokens"], r["tokens"])) if a != b),
                     None)
            raise RuntimeError(f"{tag}: request {i} differs from the G1-hit stream (first token "
                               f"difference at {k}; logprobs equal: "
                               f"{g['logprobs'] == r['logprobs']})")


async def _tier_pass(engine, reqs: list[dict], tag: str, cfg, device: str, quant: str,
                     lens: list[int]) -> dict:
    """One burst through the engine, every count zeroed just before and read
    just after; attention and int8 launches held to the substeps and to
    prefills of ``lens`` tokens; the scheduler thread's step finished."""
    from dynamo_tpu_torch.runtime.engine import Context

    steps0, eager0 = engine.total_decode_steps, engine.runner.eager_windows
    flush0 = (engine.offload_s, engine.offload_flushes, engine.offload_bytes)
    onboard0 = (engine.onboard_s, engine.onboard_bytes)
    zero_counts()
    t0 = time.perf_counter()

    async def one(r):
        ts, first, toks, lps = time.perf_counter(), None, [], []
        async for item in engine.generate(r, Context()):
            if item.get("error"):
                raise RuntimeError(f"{tag}: {item['error']}")
            if first is None and item.get("token_ids"):
                first = time.perf_counter() - ts
            toks += item.get("token_ids") or []
            lps += item.get("log_probs") or []
        return {"tokens": toks, "logprobs": lps, "ttft_s": first}

    outs = await asyncio.gather(*(one(r) for r in reqs))
    wall = time.perf_counter() - t0
    while engine.busy():
        await asyncio.sleep(0.001)
    await engine.run_on_engine_thread(lambda: None)  # the last step has finished
    counts = int8_counts()
    substeps = engine.total_decode_steps - steps0
    for r, o in zip(reqs, outs):
        if len(o["tokens"]) != r["stop"]["max_tokens"] or len(o["logprobs"]) != len(o["tokens"]):
            raise RuntimeError(f"{tag}: {len(o['tokens'])} tokens, {len(o['logprobs'])} logprobs")
    want = _ckpt_counts(cfg, substeps, device, lens)
    if quant != "int8":
        want = (want[0], 0, 0, 0)
    if counts != want or substeps == 0 or engine.runner.eager_windows != eager0:
        raise RuntimeError(f"{tag}: launches (attention, int8 kernel, int8 prefill route, int8 "
                           f"wide entry) "
                           f"{counts} != {want} for {substeps} substeps, eager windows "
                           f"{engine.runner.eager_windows - eager0}")
    n_tok = sum(len(o["tokens"]) for o in outs)
    flushes = engine.offload_flushes - flush0[1]
    return {"outs": outs, "wall_s": wall, "tokens_per_s": n_tok / wall, "substeps": substeps,
            "launches": counts, "ttft_s": [o["ttft_s"] for o in outs],
            "flushes": flushes, "flush_ms": (engine.offload_s - flush0[0]) * 1e3 / max(1, flushes),
            "offload_bytes": engine.offload_bytes - flush0[2],
            "onboard_s": engine.onboard_s - onboard0[0],
            "onboard_bytes": engine.onboard_bytes - onboard0[1]}


def _coverage(engine, reqs, bs) -> list[int]:
    """Per request, the leading run of its full prompt blocks the tiers
    hold (peek_run_len: no copy, no promotion)."""
    return [engine.tiers.peek_run_len(prompt_hashes(r, bs)) for r in reqs]


def _onboard_checks(tag, engine, reqs, bs, before, cov, stats0, got, ref, full) -> dict:
    """An onboarded pass: onboarded blocks = the coverage the tiers held
    before it (and every full prompt block), the suffix alone prefilled,
    streams bit-equal to the G1-hit pass."""
    s = engine.tiers.stats()
    onboarded = s["onboarded_blocks"] - stats0["onboarded_blocks"]
    prefilled = engine.total_prefilled - before
    want_prefilled = sum(len(r["token_ids"]) - bs * c for r, c in zip(reqs, cov))
    if onboarded != sum(cov) or sum(cov) != full or prefilled != want_prefilled:
        raise RuntimeError(f"{tag}: onboarded {onboarded} blocks, the tiers held {sum(cov)} "
                           f"({cov}) of the prompts' {full}; prefilled {prefilled} tokens, "
                           f"want {want_prefilled}")
    _same_streams(tag, got["outs"], ref["outs"])
    return {k: s[k] - stats0[k] for k in ("g2_hits", "g3_hits", "g4_hits")}


def _pages_equal(tag, engine, reqs, bs) -> int:
    """The onboarded pages, read back from G1, bit-equal to what the tiers
    hold for the same hashes → blocks compared."""
    from dynamo_tpu_torch.engine import kv_transfer

    n = 0
    for r in reqs:
        hashes = prompt_hashes(r, bs)
        ids = engine.pool.match_prefix(hashes)
        stored = engine.tiers.read_run(hashes)
        if len(ids) != len(hashes) or len(stored) != len(hashes):
            raise RuntimeError(f"{tag}: {len(ids)} G1 blocks, {len(stored)} tier blocks for "
                               f"{len(hashes)} hashes")
        got = engine.runner.extract_pages(ids)
        want = kv_transfer.concat_page_run(stored, quantized=engine.args.kv_quant == "int8",
                                           num_kv_heads=engine.cfg.num_kv_heads,
                                           dtype=engine.args.dtype)
        if len(got) != len(want) or any(a.dtype != b.dtype or a.tobytes() != b.tobytes()
                                        for a, b in zip(got, want)):
            raise RuntimeError(f"{tag}: onboarded pages differ from the stored pages")
        n += len(ids)
    return n


def _d2h_mb_per_s(engine, n_blocks: int, reps: int = 5) -> float:
    """Device→host copy rate of one offload flush: the page gather of
    ``n_blocks`` blocks and its host fetch, waited for, median of reps."""
    from dynamo_tpu_torch.engine.runner import start_host_fetch

    ids = list(range(1, n_blocks + 1))
    rates = []
    for _ in range(reps):
        t0 = time.perf_counter()
        arrs, n = engine.runner.start_extract_pages(ids)
        pages = engine.runner.finish_extract_pages(start_host_fetch(arrs), n)
        rates.append(sum(int(a.nbytes) for a in pages) / (time.perf_counter() - t0) / 1e6)
    return statistics.median(rates)


def tiers_phase(card_line: str, preset: str = "llama-8b", device: str = "cuda",
                dtype: str = "bfloat16", quant: str = "none", kv_quant: str = "none",
                model_path: str | None = None) -> dict:
    """Phase 13a, in process: one TorchEngine with G2 (TIER_HOST_BLOCKS)
    and a G3 directory serves the burst cold with its tiers switched off
    (a disabled stack), cold with them on, again (the G1-hit pass: the
    reference of every onboarded stream), and, after clear_kv_blocks, with
    the tiers off once more and then on: every block onboarded from G2.
    Then engines on the same weights with a G2 of TIER_SMALL_HOST blocks:
    one serves the burst cold (its G2 spills into a G3 directory), the
    requests whose blocks the offload bounds dropped again alone, and,
    after clear_kv_blocks, the burst onboarded from G3; a fresh one
    opened on that directory (G3 kept across restarts) serves it once
    more. With ``model_path`` every engine runs that checkpoint's weights
    (quantized as a worker loads it). → numbers and the G1-hit streams."""
    import gc

    import torch

    from dynamo_tpu_torch.block_manager.tiers import TierStack
    from dynamo_tpu_torch.engine.config import EngineArgs
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.loader import load_model

    tag = "tiers" if quant == "none" else f"tiers-int8-kv{kv_quant}"
    cfg, _ = model_source(preset, model_path)
    loaded = load_model(model_path, dtype, quant, device)[1] if model_path else None
    bs = int(ENGINE_ARGV[ENGINE_ARGV.index("--block-size") + 1])
    root = os.path.join(TIER_DIR, tag)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    reqs = tier_requests(cfg.name)
    lens = [len(r["token_ids"]) for r in reqs]
    sfx = [suffix_len(n, bs) for n in lens]
    full = sum((n - 1) // bs for n in lens)
    cuda = device == "cuda"

    def make(host_blocks: int, g3: str, params=None):
        args = EngineArgs(model=cfg, block_size=bs, num_kv_blocks=2048, max_num_seqs=8,
                          max_model_len=2048, decode_steps=8, dtype=dtype, quant=quant,
                          kv_quant=kv_quant, device=device, host_kv_blocks=host_blocks,
                          disk_kv_dir=os.path.join(root, g3))
        return TorchEngine(args, params=params, seed=0)

    async def go_a():
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        engine = await make(TIER_HOST_BLOCKS, "g3", loaded).start()
        if engine.runner.graphs is not None:
            engine.runner.warm_windows(("greedy", "simple"), (0,))
        tiers, off = engine.tiers, TierStack(None, None, None)
        out = {"params": engine.runner.params}
        try:
            engine.tiers = off
            out["off_1"] = await _tier_pass(engine, reqs, f"{tag} off", cfg, device, quant, lens)
            engine.clear_kv_blocks()
            engine.tiers = tiers
            cold = out["cold"] = await _tier_pass(engine, reqs, f"{tag} cold", cfg, device,
                                                  quant, lens)
            out["cov_cold"] = _coverage(engine, reqs, bs)
            hit = out["hit"] = await _tier_pass(engine, reqs, f"{tag} G1 hit", cfg, device,
                                                quant, sfx)
            for i, (o, c) in enumerate(zip(hit["outs"], cold["outs"])):
                o["cold_equal"] = o["tokens"] == c["tokens"]
            out["cov_hit"] = cov = _coverage(engine, reqs, bs)
            engine.clear_kv_blocks()
            engine.tiers = off
            out["off_2"] = await _tier_pass(engine, reqs, f"{tag} off", cfg, device, quant, lens)
            engine.clear_kv_blocks()
            engine.tiers = tiers
            stats0, before = tiers.stats(), engine.total_prefilled
            g2 = out["g2"] = await _tier_pass(engine, reqs, f"{tag} G2 onboard", cfg, device,
                                              quant, sfx)
            g2["hits"] = _onboard_checks(f"{tag} G2 onboard", engine, reqs, bs, before, cov,
                                         stats0, g2, hit, full)
            out["pages_compared"] = _pages_equal(f"{tag} G2 onboard", engine, reqs, bs)
            out["g2_bytes"] = _tier_bytes(tiers.host)
            out["g2_owned"] = all(a.base is None for pages in tiers.host._pages.values()
                                  for a in pages)
            out["stats"] = tiers.stats()
            out["offload_bytes"] = engine.offload_bytes
            out["d2h_mb_per_s"] = _d2h_mb_per_s(engine, TIER_OFFLOAD_PROBE)
            out["max_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0
            return out
        finally:
            engine.tiers = tiers
            await engine.stop()

    a = asyncio.run(go_a())
    params = a.pop("params")
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if not a["g2_owned"]:
        raise RuntimeError(f"{tag}: a G2 page keeps a view of a staging buffer")
    if a["cov_hit"] != [(n - 1) // bs for n in lens]:
        raise RuntimeError(f"{tag}: after the G1-hit pass G2 holds {a['cov_hit']} of the "
                           "prompts' blocks")

    async def go_b():
        engine = await make(TIER_SMALL_HOST, "g3_small", params).start()
        out = {}
        try:
            await _tier_pass(engine, reqs, f"{tag} small-G2 cold", cfg, device, quant, lens)
            # What the JAX bounds dropped (the 256 pending offloads of one
            # wave) comes back on a G1 hit of the request alone: a G2 this
            # small holds none of the other requests' blocks, so a hit pass
            # of the whole burst would queue them all again first.
            for i, c in enumerate(_coverage(engine, reqs, bs)):
                if c < (lens[i] - 1) // bs:
                    await _tier_pass(engine, [reqs[i]], f"{tag} small-G2 G1 hit {i}", cfg,
                                     device, quant, [sfx[i]])
            engine.clear_kv_blocks()
            cov = out["cov"] = _coverage(engine, reqs, bs)
            stats0, before = engine.tiers.stats(), engine.total_prefilled
            g3 = out["g3"] = await _tier_pass(engine, reqs, f"{tag} G3 onboard", cfg, device,
                                              quant, sfx)
            g3["hits"] = _onboard_checks(f"{tag} G3 onboard", engine, reqs, bs, before, cov,
                                         stats0, g3, a["hit"], full)
            out["stats"] = engine.tiers.stats()
            return out
        finally:
            await engine.stop()

    b = asyncio.run(go_b())
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    g3_dir = os.path.join(root, "g3_small")
    g3_bytes = _dir_bytes(g3_dir)

    async def go_c():
        engine = await make(TIER_SMALL_HOST, "g3_small", params).start()
        out = {}
        try:
            cov = out["cov"] = _coverage(engine, reqs, bs)
            # G3 read rate: every prompt block's file read once (np.load).
            hashes = [h for r in reqs for h in prompt_hashes(r, bs)]
            t0 = time.perf_counter()
            nbytes = sum(sum(int(x.nbytes) for x in engine.tiers.disk.get(h)) for h in hashes)
            out["g3_read_mb_per_s"] = nbytes / (time.perf_counter() - t0) / 1e6
            stats0, before = engine.tiers.stats(), engine.total_prefilled
            rs = out["restart"] = await _tier_pass(engine, reqs, f"{tag} restart", cfg, device,
                                                   quant, sfx)
            rs["hits"] = _onboard_checks(f"{tag} G3 after a restart", engine, reqs, bs, before,
                                         cov, stats0, rs, a["hit"], full)
            return out
        finally:
            await engine.stop()

    c = asyncio.run(go_c())
    del params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    if not b["g3"]["hits"]["g3_hits"] or c["restart"]["hits"]["g3_hits"] != full:
        raise RuntimeError(f"{tag}: G3 hits {b['g3']['hits']} (small G2), "
                           f"{c['restart']['hits']} (restart)")

    def mean_ms(p):
        return statistics.mean(p["ttft_s"]) * 1e3

    cold_equal = sum(o["cold_equal"] for o in a["hit"]["outs"])
    res = {
        "blocks": full, "dropped_after_cold": full - sum(a["cov_cold"]),
        "pages_compared": a["pages_compared"], "offload_bytes": a["offload_bytes"],
        "d2h_mb_per_s": a["d2h_mb_per_s"], "flush_ms_cold": a["cold"]["flush_ms"],
        "flushes_cold": a["cold"]["flushes"],
        "tokens_per_s": {k: a[k]["tokens_per_s"] for k in ("off_1", "cold", "off_2")},
        "ttft_ms": {"cold": mean_ms(a["cold"]), "g1_hit": mean_ms(a["hit"]),
                    "g2": mean_ms(a["g2"]), "g3": mean_ms(b["g3"]),
                    "restart": mean_ms(c["restart"])},
        "ttft_ms_longest": {"cold": a["cold"]["ttft_s"][-1] * 1e3,
                            "g1_hit": a["hit"]["ttft_s"][-1] * 1e3,
                            "g2": a["g2"]["ttft_s"][-1] * 1e3,
                            "g3": b["g3"]["ttft_s"][-1] * 1e3,
                            "restart": c["restart"]["ttft_s"][-1] * 1e3},
        "hits": {"g2": a["g2"]["hits"], "g3": b["g3"]["hits"], "restart": c["restart"]["hits"]},
        "onboard_s": {"g2": a["g2"]["onboard_s"], "g3": b["g3"]["onboard_s"],
                      "restart": c["restart"]["onboard_s"]},
        "onboard_bytes": a["g2"]["onboard_bytes"],
        "g3_read_mb_per_s": c["g3_read_mb_per_s"], "g2_bytes": a["g2_bytes"],
        "g3_bytes": g3_bytes, "max_mem_gib": a["max_mem_gib"], "stats": a["stats"],
        "hit_streams_equal_cold": cold_equal,
        "launches": {k: a[k]["launches"] for k in ("cold", "hit", "g2")},
        "hit_reference": [{"tokens": o["tokens"], "logprobs": o["logprobs"]}
                          for o in a["hit"]["outs"]],
    }
    log(f"{tag}: {full} full prompt blocks; the JAX bounds (64 per flush, 256 pending) left "
        f"{res['dropped_after_cold']} of them out of G2 after the cold pass, none after the G1 "
        f"hit; {a['cold']['flushes']} flushes in the cold pass at {a['cold']['flush_ms']:.2f} "
        f"host ms each, {a['offload_bytes']} bytes offloaded in all, device→host "
        f"{a['d2h_mb_per_s']:.0f} MB/s ({TIER_OFFLOAD_PROBE}-block copies) ({card_line})")
    log(f"{tag}: onboarded {full} blocks from G2 (hits {res['hits']['g2']}), from G3 with a "
        f"{TIER_SMALL_HOST}-block G2 (hits {res['hits']['g3']}) and from G3 after a restart "
        f"(hits {res['hits']['restart']}); each pass's 8 streams equal the G1-hit pass's bit for "
        f"bit (tokens and logprobs), {a['pages_compared']} onboarded pages bit-equal to the "
        f"stored ones; the G1-hit streams equal the cold ones for {cold_equal} of 8 requests")
    log(f"{tag}: cold burst tokens/s tiers off {a['off_1']['tokens_per_s']:.1f}, on "
        f"{a['cold']['tokens_per_s']:.1f}, off {a['off_2']['tokens_per_s']:.1f}; mean TTFT ms "
        + ", ".join(f"{k} {v:.1f}" for k, v in res["ttft_ms"].items())
        + "; the 1536-token request's " + ", ".join(
            f"{k} {v:.1f}" for k, v in res["ttft_ms_longest"].items())
        + "; onboard host s on the scheduler thread (lookup, concatenation, inject) "
        + ", ".join(f"{k} {v:.3f}" for k, v in res["onboard_s"].items())
        + f" for {res['onboard_bytes']} bytes"
        + f"; G3 read {c['g3_read_mb_per_s']:.0f} MB/s; G2 {a['g2_bytes']} bytes, G3 files "
        f"{g3_bytes} bytes; peak device memory {a['max_mem_gib']:.2f} GiB ({card_line})")
    return res


def tiers_worker_phase(card_line: str, reference: list, preset: str = "llama-8b",
                       device: str = "cuda", dtype: str = "bfloat16", quant: str = "none",
                       kv_quant: str = "none", model_path: str | None = None) -> dict:
    """Phase 13b: the store and two port workers on one card (the main
    path's engine arguments, ``--disagg off``), both with one shared
    ``--fleet-kv-dir``; A with ``--host-kv-blocks TIER_HOST_BLOCKS``, B with
    a G2 of TIER_SMALL_HOST blocks; requests over a DIRECT router. A serves
    the burst cold and again (its G1-hit pass); B gets the burst with a
    ``peer_prefix`` hint naming A, one request at a time, fetches every
    prompt's blocks from A's tiers and spills them into the fleet
    directory; A serves 8 other
    prompts, its G2 overflows and spills the burst's blocks there too; B,
    its cache cleared, serves the burst again from G2 and G4. ``reference``:
    13a's G1-hit streams, which every stream here must equal. With
    ``model_path`` both workers serve that checkpoint (13a's weights)."""

    from dynamo_tpu_torch.engine.config import EngineArgs
    from dynamo_tpu_torch.llm.peer_kv import KV_PREFIX_ENDPOINT
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.engine import Context
    from dynamo_tpu_torch.runtime.push_router import RouterMode
    from dynamo_tpu_torch.transfer.stream import read_kv_payload_frames

    tag = "tiers-workers" if quant == "none" else f"tiers-workers-int8-kv{kv_quant}"
    cfg, weights = model_source(preset, model_path)
    bs = int(ENGINE_ARGV[ENGINE_ARGV.index("--block-size") + 1])
    block_bytes = EngineArgs(model=cfg, block_size=bs, dtype=dtype,
                             kv_quant=kv_quant).kv_bytes_per_block()
    fleet = os.path.join(TIER_DIR, tag, "g4")
    shutil.rmtree(os.path.dirname(fleet), ignore_errors=True)
    os.makedirs(fleet)
    reqs = tier_requests(cfg.name)
    other = tier_requests(cfg.name, prompts=[p[::-1] for p in burst_prompts()])
    argv = [*weights, "--dtype", dtype, "--device", device, "--quant", quant,
            "--kv-quant", kv_quant, "--disagg", "off", "--fleet-kv-dir", fleet, *ENGINE_ARGV]
    procs: list[Proc] = []
    store_port = _free_port()
    store_url = f"tcp://127.0.0.1:{store_port}"
    sys_ports = {}
    try:
        store = Proc(f"{tag}-store", ["dynamo_tpu_torch.runtime.store_server", "--host",
                                      "127.0.0.1", "--port", str(store_port)])
        procs.append(store)
        store.wait_for(r"store server: tcp://", 60)
        workers = {}
        for name, host in (("a", TIER_HOST_BLOCKS), ("b", TIER_SMALL_HOST)):
            sys_ports[name] = _free_port()
            workers[name] = Proc(f"{tag}-{name}", [
                "dynamo_tpu_torch.worker", "--store-url", store_url,
                "--host-kv-blocks", str(host), *argv],
                env={"DYNTPU_SYSTEM_ENABLED": "1", "DYNTPU_SYSTEM_PORT": str(sys_ports[name])})
            procs.append(workers[name])
        for name, w in workers.items():
            _, secs = w.wait_for(r"worker: serving .* window graphs captured", 600)
            log(f"{tag}: worker {name} registered {secs:.2f}s after launch ({card_line})")

        async def drive():
            rt = await DistributedRuntime.create(store_url=store_url)
            try:
                comp = rt.namespace("dynamo").component("backend")
                push = await comp.endpoint("generate").router(RouterMode.DIRECT)
                await push.discovery.wait_for_instances(2)
                fetch = await comp.endpoint(KV_PREFIX_ENDPOINT).router(RouterMode.DIRECT)
                await fetch.discovery.wait_for_instances(2)

                async def one(wid, r):
                    ts, first, toks, lps = time.perf_counter(), None, [], []
                    async for item in push.generate(r, Context(), instance_id=wid):
                        if item.get("error"):
                            raise RuntimeError(f"{tag}: {item['error']}")
                        if first is None and item.get("token_ids"):
                            first = time.perf_counter() - ts
                        toks += item.get("token_ids") or []
                        lps += item.get("log_probs") or []
                    return {"tokens": toks, "logprobs": lps, "ttft_s": first}

                async def burst(wid, rs):
                    t0 = time.perf_counter()
                    outs = await asyncio.gather(*(one(wid, r) for r in rs))
                    return outs, time.perf_counter() - t0

                ids = sorted(push.discovery.instance_ids())
                # Which instance is A: a one-token probe to the first; B's
                # counters are read as deltas from after the probes.
                probe = dict(reqs[0], token_ids=[1], stop={"max_tokens": 1, "ignore_eos": True})
                await one(ids[0], probe)
                got = usr1_counters(workers["a"])["generated_tokens"]
                wid_a, wid_b = (ids[0], ids[1]) if got else (ids[1], ids[0])
                out = {"b_base": usr1_counters(workers["b"])}
                out["cold"], _ = await burst(wid_a, reqs)
                out["hit"], _ = await burst(wid_a, reqs)
                await asyncio.sleep(1.0)  # A's last offloads land
                # Peer fetch rate: the longest prompt's blocks from A's tiers.
                t0 = time.perf_counter()
                payload = await read_kv_payload_frames(fetch.generate(
                    {"hashes": prompt_hashes(reqs[-1], bs)}, Context(), instance_id=wid_a))
                secs = time.perf_counter() - t0
                out["peer_fetch_bytes"] = sum(int(p.nbytes) for p in payload.pages())
                out["peer_fetch_mb_per_s"] = out["peer_fetch_bytes"] / secs / 1e6
                hinted = [dict(r, kv_transfer_params={"peer_prefix": {
                    "instance_id": wid_a, "num_blocks": (len(r["token_ids"]) - 1) // bs}})
                    for r in reqs]
                # One request at a time: each wave's sealed blocks then fit the
                # 256 pending offloads, so B's G2 and G4 end up holding them all.
                out["peer"] = [await one(wid_b, r) for r in hinted]
                await asyncio.sleep(1.0)
                out["b_peer"] = usr1_counters(workers["b"])
                out["other"], _ = await burst(wid_a, other)
                await asyncio.sleep(1.0)
                out["a_after_other"] = usr1_counters(workers["a"])
                cleared = None
                clear = await comp.endpoint("clear_kv").router(RouterMode.DIRECT)
                await clear.discovery.wait_for_instances(2)
                async for item in clear.generate({}, Context(), instance_id=wid_b):
                    cleared = item
                out["cleared"] = cleared
                out["g4"], _ = await burst(wid_b, reqs)
                await asyncio.sleep(1.0)
                out["b_final"] = usr1_counters(workers["b"])
                return out
            finally:
                await rt.shutdown()
                await rt.store.close()

        out = asyncio.run(drive())
        _same_streams(f"{tag}: worker A's G1-hit pass", out["hit"], reference)
        _same_streams(f"{tag}: worker B after peer fetches", out["peer"], reference)
        _same_streams(f"{tag}: worker B from G2 + G4", out["g4"], reference)
        b0, bp, bf, ao = out["b_base"], out["b_peer"], out["b_final"], out["a_after_other"]
        full = sum((len(r["token_ids"]) - 1) // bs for r in reqs)
        if bp["peer_fetches"] != len(reqs) or bp["peer_fetch_failures"]:
            raise RuntimeError(f"{tag}: worker B peer fetches {bp['peer_fetches']}, failures "
                               f"{bp['peer_fetch_failures']}, for {len(reqs)} prompts")
        injected = bp["inject_bytes"] - b0["inject_bytes"]
        prefilled = bp["prefilled_tokens"] - b0["prefilled_tokens"]
        if injected != full * block_bytes or prefilled != sum(
                len(r["token_ids"]) - bs * ((len(r["token_ids"]) - 1) // bs) for r in reqs):
            raise RuntimeError(f"{tag}: worker B injected {injected} bytes (want {full} x "
                               f"{block_bytes}), prefilled {prefilled}")
        metrics = _get_text(sys_ports["b"], "/metrics")
        g4_hits = _metric(metrics, "dynamo_tpu_tier_g4_hits_total") or 0.0
        g4_dedup = _metric(metrics, "dynamo_tpu_tier_g4_dedup_blocks_total") or 0.0
        tb = bf["tiers"]
        if (g4_hits <= 0 or tb["g4_hits"] != g4_hits or tb["g4_dedup_blocks"] <= 0
                or tb["g4_dedup_blocks"] != g4_dedup
                or tb["onboarded_blocks"] - bp["tiers"]["onboarded_blocks"] != full):
            raise RuntimeError(f"{tag}: worker B tiers {tb} (after the peer pass "
                               f"{bp['tiers']}), /metrics g4 hits {g4_hits} dedup {g4_dedup}")
        counts = {}
        for name in ("a", "b"):
            counts[name] = workers[name].stop()
        counts["store"] = store.stop()
        if set(counts.values()) != {0}:
            raise RuntimeError(f"{tag}: exit codes {counts}")

        def mean_ms(outs):
            return statistics.mean(o["ttft_s"] for o in outs) * 1e3

        res = {"peer_fetches": bp["peer_fetches"], "peer_inject_bytes": injected,
               "peer_inject_s": bp["inject_s"] - b0["inject_s"], "peer_fetch_mb_per_s": out["peer_fetch_mb_per_s"],
               "peer_fetch_bytes": out["peer_fetch_bytes"],
               "ttft_ms": {"cold": mean_ms(out["cold"]), "g1_hit": mean_ms(out["hit"]),
                           "peer": mean_ms(out["peer"]), "g2_g4": mean_ms(out["g4"])},
               "b_tiers": tb, "a_tiers": ao["tiers"], "g4_files": len(os.listdir(fleet)),
               "g4_bytes": _dir_bytes(fleet), "exit_codes": counts}
        log(f"{tag}: worker B fetched all {len(reqs)} prompts' {full} blocks from A's tiers "
            f"({injected} bytes injected in {res['peer_inject_s']:.3f}s on its scheduler "
            f"thread), the longest prompt's {out['peer_fetch_bytes']} bytes over kv_prefix at "
            f"{out['peer_fetch_mb_per_s']:.0f} MB/s; after A spilled the burst into the fleet "
            f"directory, B served it from G2 + G4: tier_g4_hits_total {g4_hits:.0f}, "
            f"tier_g4_dedup_blocks_total {g4_dedup:.0f} (A: {ao['tiers']['g4_dedup_blocks']} "
            f"dedup, {ao['tiers']['g4_hits']} hits); {res['g4_files']} G4 files, "
            f"{res['g4_bytes']} bytes; every stream equals 13a's G1-hit pass bit for bit; mean "
            f"TTFT ms " + ", ".join(f"{k} {v:.1f}" for k, v in res["ttft_ms"].items())
            + f"; exit codes {counts} ({card_line})")
        return res
    finally:
        for p in procs:
            p.kill()
        shutil.rmtree(os.path.dirname(fleet), ignore_errors=True)


MIG_LENS = [256, 352, 448, 544, 640, 736, 832, 1024]  # prompt tokens of the 8 requests
MIG_TEMPS = [0.0, 0.0, 0.0, 0.7, 0.0, 0.0, 0.7, 0.0]
MIG_TOKENS = 1000        # ~10 s a row at ~100 tokens/s: room for six relocations in turn
MIG_AT = 64              # tokens a row has emitted before it is migrated
MIG_NEW_AT = 16          # tokens the new rows on B have emitted before its pool move
MIG_ROWS = [0, 2, 5, 7]  # greedy rows migrated A → B, two at a time
MIG_NEW = [1, 4]         # greedy rows sent to B before its pool move
MIG_CHAOS_ROW = 6        # the sampled row the chaos cell offers for migration
MIG_CHAOS_TOKENS = 384   # the chaos cell's streams: its fallback lands well before
MIG_CHAOS_PLAN = "cutover:dest"


def migration_requests(model: str, max_tokens: int = MIG_TOKENS) -> list[dict]:
    """Phase 14's 8 requests: byte-token prompts of MIG_LENS, seeds
    2000-2007, MIG_TEMPS, logprobs with the top 2 (the gap rule reads
    them)."""
    import numpy as np

    rng = np.random.default_rng(2025)
    return [{"model": model, "token_ids": [int(c) for c in rng.integers(32, 127, n)],
             "sampling": {"temperature": MIG_TEMPS[i], "seed": 2000 + i, "logprobs": True,
                          "top_logprobs": 2},
             "stop": {"max_tokens": max_tokens, "ignore_eos": True}}
            for i, n in enumerate(MIG_LENS)]


class LegRecorder:
    """The router under the Migration operator, recording each leg of each
    request (by context id): the arrival times of its first and last token
    frames, its token count and whether it ended in a handoff marker."""

    def __init__(self, inner):
        self.inner = inner
        self.legs: dict[str, list[dict]] = {}

    async def generate(self, request, context):
        leg = {"start": time.perf_counter(), "first": None, "last": None, "tokens": 0,
               "marker": None}
        self.legs.setdefault(context.id, []).append(leg)
        async for item in self.inner.generate(request, context):
            if isinstance(item, dict):
                if item.get("token_ids"):
                    now = time.perf_counter()
                    leg["first"] = leg["first"] or now
                    leg["last"] = now
                    leg["tokens"] += len(item["token_ids"])
                if item.get("migration") is not None:
                    leg["marker"] = time.perf_counter()
            yield item


def relocated_divergence(got: dict, ref: dict, cut: int, tag: str) -> int | None:
    """Hold a relocated stream to its reference: equal up to ``cut`` (the
    first cutover; the source decoded that far), then token for token
    except that the first difference may fall where the reference's top-2
    logprob gap is under SPEC_GAP_TOL (the destination recomputed the
    < 16-token suffix by prefill, not by decode) → that index or None."""
    d = _first_divergence(got["tokens"], ref["tokens"])
    if d is None and len(got["tokens"]) == len(ref["tokens"]):
        return None
    if d is None or d < cut:
        raise RuntimeError(f"{tag}: differs from the reference at {d}, before the cutover at "
                           f"{cut} (lengths {len(got['tokens'])} / {len(ref['tokens'])})")
    if got["logprobs"][:cut] != ref["logprobs"][:cut]:
        raise RuntimeError(f"{tag}: logprobs differ from the reference before the cutover")
    top = ref["top"][d]
    gap = top[0][1] - top[1][1]
    if abs(gap) >= SPEC_GAP_TOL:
        raise RuntimeError(f"{tag}: leaves the reference at {d} (cutover at {cut}) where its "
                           f"top-2 gap is {gap:.4f} >= {SPEC_GAP_TOL}")
    return d


def _row_tps(leg: dict) -> float:
    return (leg["tokens"] - 1) / (leg["last"] - leg["first"])


def migration_phase(card_line: str, preset: str = "llama-8b", device: str = "cuda",
                    dtype: str = "bfloat16", quant: str = "none", kv_quant: str = "none",
                    max_tokens: int = MIG_TOKENS, chaos: bool = True,
                    model_path: str | None = None) -> dict:
    """Phase 14: live migration between port workers on one card. The store
    and three ``python -m dynamo_tpu_torch.worker --autoscaler on --disagg
    off`` workers (the main path's engine arguments, seed 0: the same
    weights); C runs with ``migration_cut_plan = MIG_CHAOS_PLAN``. Streams
    go through this process's Migration operator over a KvPushRouter (each
    first leg pinned by the router's resume pin, as resumed legs are),
    migrations through each worker's workerctl/admin endpoint:

    - reference: the 8 requests on A, no migration;
    - chaos: the same on C, MIG_CHAOS_TOKENS each; at MIG_AT tokens C
      offers MIG_CHAOS_ROW to A, the cutover falls back
      (``chaos:cutover:dest``) and every stream equals the reference's
      first MIG_CHAOS_TOKENS bit for bit; C retires. Meanwhile B serves one
      greedy top-2 request, so the window graph its later streams replay
      is captured before them (start-up captures windows without top-n);
    - clean: the same on A, its cache cleared; at MIG_AT tokens the
      MIG_ROWS migrate to B, two at a time: 4 ok, no fallback, 4 markers
      consumed; the other rows equal the reference bit for bit, migrated
      ones up to the cutover and then by the gap rule
      (``relocated_divergence``);
    - pool move: MIG_NEW sent to B; at MIG_AT tokens B's ``set_role
      prefill`` relocates its running streams to A, and all complete
      under the same rule; ``set_role decode``; the pages B injected equal
      the pages A held for the same blocks (a prefill-only export of the
      same tokens from each: a prefix hit on those blocks; the last
      streamed block is left out, see below); B retires and no
      ``autoscaler/<ns>/workers/`` key of B or C remains.

    Each worker's attention launches equal num_layers x its decode
    substeps, no window runs eagerly, and every process exits 0. Without
    ``chaos`` there is no C and no chaos cell. With ``model_path`` the
    workers serve that checkpoint."""
    import numpy as np

    from dynamo_tpu_torch.kv_router.router import KvPushRouter, KvRouterConfig
    from dynamo_tpu_torch.llm.migration import Migration
    from dynamo_tpu_torch.planner.actuate import read_pools, worker_key
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.engine import Context
    from dynamo_tpu_torch.runtime.push_router import RouterMode
    from dynamo_tpu_torch.transfer.stream import read_kv_payload_frames

    tag = "migration" if quant == "none" else f"migration-int8-kv{kv_quant}"
    cfg, weights = model_source(preset, model_path)
    bs = int(ENGINE_ARGV[ENGINE_ARGV.index("--block-size") + 1])
    reqs = migration_requests(cfg.name, max_tokens)
    argv = ["dynamo_tpu_torch.worker", *weights, "--dtype", dtype, "--device", device,
            "--quant", quant, "--kv-quant", kv_quant, "--disagg", "off", "--autoscaler", "on",
            *ENGINE_ARGV]
    procs: list[Proc] = []
    store_port = _free_port()
    store_url = f"tcp://127.0.0.1:{store_port}"
    names = "abc" if chaos else "ab"
    sys_ports = {name: _free_port() for name in names}
    try:
        store = Proc(f"{tag}-store", ["dynamo_tpu_torch.runtime.store_server", "--host",
                                      "127.0.0.1", "--port", str(store_port)])
        procs.append(store)
        store.wait_for(r"store server: tcp://", 60)
        workers = {}
        for name in names:
            env = {"DYNTPU_SYSTEM_ENABLED": "1", "DYNTPU_SYSTEM_PORT": str(sys_ports[name])}
            if name == "c":
                env.update(DYNTPU_CHAOS_ENABLED="1",
                           DYNTPU_CHAOS_MIGRATION_CUT_PLAN=MIG_CHAOS_PLAN)
            workers[name] = Proc(f"{tag}-{name}", [*argv, "--store-url", store_url], env=env)
            procs.append(workers[name])
        launch = {name: w.wait_for(r"autoscaled decode worker: serving .* window graphs", 600)[1]
                  for name, w in workers.items()}
        log(f"{tag}: workers registered " + ", ".join(f"{k} {v:.2f}s" for k, v in launch.items())
            + f" after launch ({card_line})")

        async def counters(name):
            return await asyncio.to_thread(usr1_counters, workers[name])

        async def metrics(name):
            _, _, pieces, _ = await http_request(sys_ports[name], "/metrics", method="GET")
            return b"".join(p for _, p in pieces).decode()

        async def drive():
            rt = await DistributedRuntime.create(store_url=store_url)
            try:
                ns = rt.namespace("dynamo")
                push = await ns.component("backend").endpoint("generate").router(RouterMode.DIRECT)
                fetch = await ns.component("backend").endpoint("kv_fetch").router(RouterMode.DIRECT)
                clear = await ns.component("backend").endpoint("clear_kv").router(RouterMode.DIRECT)
                admin = await ns.component("workerctl").endpoint("admin").router(RouterMode.DIRECT)
                for r in (push, fetch, clear, admin):
                    await r.discovery.wait_for_instances(len(names))
                by_pid = {w.pid: w.instance_id
                          for w in (await read_pools(rt.store, "dynamo"))["decode"]}
                wid = {name: by_pid[w.proc.pid] for name, w in workers.items()}
                rec = LegRecorder(await KvPushRouter(
                    push, KvRouterConfig(block_size=bs, use_kv_events=False)).start())
                op = Migration(rec, migration_limit=0)
                loop = asyncio.get_running_loop()

                async def rpc(name, payload):
                    last = {}
                    async for f in admin.generate(payload, Context(), instance_id=wid[name]):
                        last = f
                    return last

                async def one(i, target, rid, n=None):
                    r = dict(reqs[i], kv_transfer_params={
                        "migration_resume": {"instance": wid[target]}})
                    if n is not None:
                        r["stop"] = dict(r["stop"], max_tokens=n)
                    got = {"tokens": [], "logprobs": [], "top": [], "finish": None}
                    async for item in op.generate(r, Context(rid)):
                        if item.get("error"):
                            raise RuntimeError(f"{tag}: request {rid}: {item['error']}")
                        got["tokens"] += item.get("token_ids") or []
                        got["logprobs"] += item.get("log_probs") or []
                        got["top"] += item.get("top_log_probs") or []
                        got["finish"] = item.get("finish_reason") or got["finish"]
                    return got

                def start(target, idx, label, n=None):
                    return {i: loop.create_task(one(i, target, f"{label}-{i}", n)) for i in idx}

                async def until(rid, n):
                    while sum(g["tokens"] for g in rec.legs.get(rid, [])) < n:
                        await asyncio.sleep(0.005)

                out = {"wid": wid}
                # Reference: A, no migration.
                t0 = time.perf_counter()
                tasks = start("a", range(8), "ref")
                out["ref"] = [await tasks[i] for i in range(8)]
                out["ref_wall_s"] = time.perf_counter() - t0
                # Chaos: C offers MIG_CHAOS_ROW to A; the cutover falls back.
                # Meanwhile B serves one greedy top-2 request: the worker
                # captures its windows at start-up without top-n outputs, and
                # the streams B takes later must not wait for that capture.
                tasks = start("c", range(8), "chaos", MIG_CHAOS_TOKENS) if chaos else {}
                warm = dict(reqs[0], sampling={"temperature": 0.0, "seed": 0, "logprobs": True,
                                               "top_logprobs": 2},
                            stop={"max_tokens": 32, "ignore_eos": True})
                async for _ in push.generate(warm, Context(), instance_id=wid["b"]):
                    pass
                if chaos:
                    await until(f"chaos-{MIG_CHAOS_ROW}", MIG_AT)
                    out["chaos_reply"] = await rpc("c", {"cmd": "migrate_out",
                                                         "request_id": f"chaos-{MIG_CHAOS_ROW}",
                                                         "dest_instance": wid["a"]})
                    out["chaos"] = [await tasks[i] for i in range(8)]
                    out["c_counters"] = await counters("c")
                    out["c_metrics"] = await metrics("c")
                    out["c_retire"] = await rpc("c", {"cmd": "retire"})
                # Clean migrations A → B, two at a time, from a cleared cache.
                async for item in clear.generate({}, Context(), instance_id=wid["a"]):
                    out["a_cleared"] = item
                out["a_before"] = await counters("a")
                out["b_before"] = await counters("b")
                t0 = time.perf_counter()
                tasks = start("a", range(8), "mig")
                for i in MIG_ROWS:
                    await until(f"mig-{i}", MIG_AT)

                async def move(i):
                    ts = time.perf_counter()
                    rep = await rpc("a", {"cmd": "migrate_out", "request_id": f"mig-{i}",
                                          "dest_instance": wid["b"]})
                    return i, dict(rep, seconds=time.perf_counter() - ts)

                out["moves"] = {}
                for pair in (MIG_ROWS[:2], MIG_ROWS[2:]):
                    out["moves"].update(await asyncio.gather(*(move(i) for i in pair)))
                out["resumes_after_moves"] = op.counts.get("resume", 0)
                # Pool move: B takes two new requests, then moves to prefill,
                # relocating its running streams to A.
                new = start("b", MIG_NEW, "new")
                for i in MIG_NEW:
                    await until(f"new-{i}", MIG_NEW_AT)
                ts = time.perf_counter()
                out["set_prefill"] = await rpc("b", {"cmd": "set_role", "role": "prefill"})
                out["set_prefill_s"] = time.perf_counter() - ts
                out["mig"] = [await tasks[i] for i in range(8)]
                out["new"] = {i: await new[i] for i in MIG_NEW}
                out["mig_wall_s"] = time.perf_counter() - t0
                ts = time.perf_counter()
                out["set_decode"] = await rpc("b", {"cmd": "set_role", "role": "decode"})
                out["set_decode_s"] = time.perf_counter() - ts
                # The pages B injected against the pages A held: a prefill-only
                # export of each migrated row's streamed tokens from both, a
                # prefix hit on them. The last streamed block is left out: the
                # engine registers a block one drain after the window that
                # sealed it, so a row frozen right after that window leaves it
                # unregistered at the source, whose export would recompute it.
                for r in (push, fetch):
                    await r.discovery.wait_for_instances(2)
                out["pages"] = {}
                for i in MIG_ROWS:
                    n = out["moves"][i]["kv_blocks"] - 1
                    probe = {"model": cfg.name, "token_ids": (reqs[i]["token_ids"] + out["ref"][
                        i]["tokens"])[: n * bs + 1],
                        "sampling": {"temperature": 0.0, "seed": 0},
                        "stop": {"max_tokens": 1, "ignore_eos": True},
                        "kv_transfer_params": {"do_remote_decode": True}}
                    got = {}
                    for name in ("a", "b"):
                        meta = None
                        async for item in push.generate(dict(probe), Context(),
                                                        instance_id=wid[name]):
                            meta = item.get("kv_transfer_params") or meta
                        if not meta or meta.get("num_blocks") != n:
                            raise RuntimeError(f"{tag}: worker {name} exported {meta} for row "
                                               f"{i} (want {n} blocks)")
                        kv = await read_kv_payload_frames(fetch.generate(
                            {"handle": meta["remote_handle"]}, Context(),
                            instance_id=wid[name]))
                        got[name] = [np.asarray(p) for p in kv.pages()]
                    diff = [sorted({int(b) for b in np.nonzero(x != y)[1]})
                            for x, y in zip(got["a"], got["b"])]
                    out["pages"][i] = (all(not d for d in diff), sum(int(p.nbytes) for p in
                                                                     got["b"]), diff)
                out["a_counters"] = await counters("a")
                out["b_counters"] = await counters("b")
                out["a_metrics"] = await metrics("a")
                out["b_metrics"] = await metrics("b")
                ts = time.perf_counter()
                out["b_retire"] = await rpc("b", {"cmd": "retire"})
                while await rt.store.get(worker_key("dynamo", wid["b"])) is not None:
                    await asyncio.sleep(0.01)
                out["retire_s"] = time.perf_counter() - ts
                out["keys_left"] = [e.key for e in
                                    await rt.store.get_prefix("autoscaler/dynamo/workers/")]
                out["legs"] = rec.legs
                out["resumes"] = op.counts.get("resume", 0)
                await rec.inner.close()
                return out
            finally:
                await rt.shutdown()
                await rt.store.close()

        out = asyncio.run(drive())
        try:
            res = _check_migration(tag, cfg, out, device, max_tokens)
        except Exception:
            log(f"{tag}: what the failed pass recorded: " + json.dumps({
                "moves": out["moves"], "legs": out["legs"], "chaos_reply": out.get("chaos_reply"),
                "counters": {k: out.get(k) for k in ("a_before", "a_counters", "b_before",
                                                     "b_counters", "c_counters")}}, default=str))
            raise
        codes = {name: workers[name].proc.wait(120) for name in names[1:]}
        codes["a"] = workers["a"].stop()
        codes["store"] = store.stop()
        for name in names[1:]:
            workers[name].stop()
        if set(codes.values()) != {0}:
            raise RuntimeError(f"{tag}: exit codes {codes}")
        res["exit_codes"] = codes
        res["launch_to_registered_s"] = launch
        _log_migration(tag, res, card_line)
        return res
    finally:
        for p in procs:
            p.kill()


def _labelled(text: str, name: str) -> dict[str, float]:
    """One labelled series of a worker's /metrics → {label value: sample}."""
    return {m.group(1): float(m.group(2)) for m in re.finditer(
        rf'^dynamo_tpu_{name}\{{[a-z_]+="([^"]*)"\}} ([0-9.eE+-]+)$', text, re.M)}


def _check_migration(tag: str, cfg, out: dict, device: str, max_tokens: int) -> dict:
    """Phase 14's checks on what ``migration_phase`` drove → its numbers.
    Attention launches are num_layers x substeps on the card, none on the
    CPU (the plain version runs)."""
    ref, legs, moves = out["ref"], out["legs"], out["moves"]
    if any(len(r["tokens"]) != max_tokens or r["finish"] != "length" for r in ref):
        raise RuntimeError(f"{tag}: the reference pass did not finish every stream")
    # The chaos cell: a typed fallback, in-place decode, bit-equal streams.
    want = {"ok": False, "reason": f"chaos:{MIG_CHAOS_PLAN}"}
    if "chaos" in out:
        if out["chaos_reply"] != want:
            raise RuntimeError(f"{tag}: chaos migrate_out answered {out['chaos_reply']}, "
                               f"want {want}")
        n = MIG_CHAOS_TOKENS
        if any(len(g["tokens"]) != n or g["finish"] != "length" for g in out["chaos"]):
            raise RuntimeError(f"{tag}: the chaos cell did not finish every stream")
        _same_streams(f"{tag}: the chaos cell", out["chaos"],
                      [{"tokens": r["tokens"][:n], "logprobs": r["logprobs"][:n]} for r in ref])
        fb = _labelled(out["c_metrics"], "migration_fallback_total")
        if fb != {f"chaos:{MIG_CHAOS_PLAN}": 1.0} or out["c_retire"] != {"ok": True,
                                                                        "retiring": True}:
            raise RuntimeError(f"{tag}: worker C fallbacks {fb}, retire {out['c_retire']}")
    # Clean migrations: 4 ok, no fallback, 4 markers consumed.
    if not all(m.get("ok") for m in moves.values()) or out["resumes_after_moves"] != 4:
        raise RuntimeError(f"{tag}: migrations {moves}, markers {out['resumes_after_moves']}")
    att = _labelled(out["a_metrics"], "migration_attempts_total")
    fbs = {name: _labelled(out[f"{name}_metrics"], "migration_fallback_total")
           for name in ("a", "b")}
    if att.get("ok") != 4 or any(v for f in fbs.values() for v in f.values()):
        raise RuntimeError(f"{tag}: worker A attempts {att}, fallbacks {fbs}")
    divergence, cutover, stall = {}, {}, {}
    for label, rows, got_of in (("mig", range(8), lambda i: out["mig"][i]),
                                ("new", MIG_NEW, lambda i: out["new"][i])):
        for i in rows:
            rid, got = f"{label}-{i}", got_of(i)
            lg = legs[rid]
            if len(got["tokens"]) != max_tokens or got["finish"] != "length":
                raise RuntimeError(f"{tag}: {rid} ended with {len(got['tokens'])} tokens, "
                                   f"{got['finish']}")
            if label == "mig" and (i in MIG_ROWS) != (len(lg) > 1
                                                      and lg[0]["marker"] is not None):
                raise RuntimeError(f"{tag}: {rid} ran {len(lg)} legs")
            if len(lg) == 1:
                _same_streams(f"{tag}: {rid}", [got], [ref[i]])
                continue
            cutover[rid] = lg[0]["tokens"]
            # last source token → marker (cutover, commit, finish) → the
            # resumed leg's dispatch → its first token.
            stall[rid] = (lg[1]["first"] - lg[0]["last"], lg[0]["marker"] - lg[0]["last"],
                          lg[1]["start"] - lg[0]["marker"], lg[1]["first"] - lg[1]["start"])
            divergence[rid] = relocated_divergence(got, ref[i], lg[0]["tokens"], f"{tag}: {rid}")
    # The pool move relocated B's streams; B went back to decode, retired.
    b0, b1, a0, a1 = out["b_before"], out["b_counters"], out["a_before"], out["a_counters"]
    relocated = (b1.get("migration") or {}).get("outcomes", {}).get("ok", 0)
    if (out["set_prefill"].get("role") != "prefill" or out["set_decode"].get("role") != "decode"
            or relocated < 1 or (b1.get("migration") or {}).get("fallback_reasons")):
        raise RuntimeError(f"{tag}: pool move {out['set_prefill']} / {out['set_decode']}, "
                           f"worker B migrations {b1.get('migration')}")
    bad = {i: diff for i, (same, _, diff) in out["pages"].items() if not same}
    if bad:
        raise RuntimeError(f"{tag}: injected pages differ from the source's (row: blocks "
                           f"differing in each page array) {bad}; kv_blocks "
                           f"{ {i: m['kv_blocks'] for i, m in moves.items()} }, cutover "
                           f"{cutover}, legs { {k: len(v) for k, v in legs.items()} }")
    if out["keys_left"] != [out["keys_left"][0]] or not out["keys_left"][0].endswith(
            f"{out['wid']['a']:x}"):
        raise RuntimeError(f"{tag}: autoscaler keys left {out['keys_left']}")
    counters = {"a": a1, "b": b1, **({"c": out["c_counters"]} if "chaos" in out else {})}
    for name, c in counters.items():
        want = cfg.num_layers * c["decode_substeps"] if device == "cuda" else 0
        if (c["paged_attention_launches"] != want
                or c["decode_substeps"] <= 0 or c["eager_windows"]):
            raise RuntimeError(f"{tag}: worker {name} attention launches "
                               f"{c['paged_attention_launches']} for {c['decode_substeps']} "
                               f"substeps, {c['eager_windows']} eager windows")
    unmoved = [i for i in range(8) if i not in MIG_ROWS]
    pumps = {name: ((c1["migration_pump_s"] - c0["migration_pump_s"])
                    / max(1, c1["migration_pumps"] - c0["migration_pumps"]) * 1e3,
                    c1["migration_pumps"] - c0["migration_pumps"])
             for name, c0, c1 in (("a", a0, a1), ("b", b0, b1))}
    return {
        "migrations": {i: {"kv_bytes": m["kv_bytes"], "kv_blocks": m["kv_blocks"],
                           "seconds": m["seconds"],
                           "mb_per_s": m["kv_bytes"] / m["seconds"] / 1e6,
                           "cutover_gap_s": m["cutover_gap_s"]} for i, m in moves.items()},
        "stall_s": stall, "cutover_tokens": cutover, "divergence": divergence,
        "pump_ms": {k: v[0] for k, v in pumps.items()},
        "pumps": {k: v[1] for k, v in pumps.items()},
        "unmigrated_tps": statistics.mean(_row_tps(legs[f"mig-{i}"][0]) for i in unmoved),
        "reference_tps": statistics.mean(_row_tps(legs[f"ref-{i}"][0]) for i in unmoved),
        "ref_wall_s": out["ref_wall_s"], "mig_wall_s": out["mig_wall_s"],
        "relocated_by_pool_move": relocated, "set_prefill_s": out["set_prefill_s"],
        "set_decode_s": out["set_decode_s"], "retire_s": out["retire_s"],
        "pages_compared_bytes": sum(n for _, n, _ in out["pages"].values()),
        "peak_device_gib": {k: c["peak_device_bytes"] / 2**30 for k, c in counters.items()},
        "launches": {k: c["paged_attention_launches"] for k, c in counters.items()},
        "int8_launches": {k: c["int8_matmul_launches"] for k, c in counters.items()},
        "int8_wide_launches": {k: c["int8_matmul_wide_launches"] for k, c in counters.items()},
        "substeps": {k: c["decode_substeps"] for k, c in counters.items()},
        "chaos_reason": out["chaos_reply"]["reason"] if "chaos" in out else None,
        "graphs_captured": {name: (c1["graphs_captured"] - c0["graphs_captured"],
                                   c1["graph_capture_s"] - c0["graph_capture_s"])
                            for name, c0, c1 in (("a", a0, a1), ("b", b0, b1))},
        "b_phase_s": {k: v - b0["phase_s"].get(k, 0.0) for k, v in b1["phase_s"].items()},
        "b_inject_s": b1["inject_s"] - b0["inject_s"],
    }


def _log_migration(tag: str, res: dict, card_line: str) -> None:
    log(f"{tag}: 4 clean migrations A → B: " + "; ".join(
        f"row {i}: {m['kv_blocks']} blocks, {m['kv_bytes']} bytes in {m['seconds']:.3f}s "
        f"({m['mb_per_s']:.1f} MB/s), cutover gap {m['cutover_gap_s'] * 1e3:.1f} ms"
        for i, m in res["migrations"].items())
        + "; client-visible stall (last source token → marker, → resumed leg's dispatch, → "
        "its first token) " + ", ".join(
            f"{k} {v[0] * 1e3:.1f} ms ({v[1] * 1e3:.1f} + {v[2] * 1e3:.1f} + {v[3] * 1e3:.1f})"
            for k, v in res["stall_s"].items())
        + f"; first divergence after the cutover {res['divergence']} (cutover at "
        f"{res['cutover_tokens']})")
    log(f"{tag}: host ms per _pump_migration A {res['pump_ms']['a']:.3f} "
        f"({res['pumps']['a']} pumps), B {res['pump_ms']['b']:.3f} ({res['pumps']['b']}); "
        f"unmigrated rows {res['unmigrated_tps']:.2f} tokens/s each with migrations running vs "
        f"{res['reference_tps']:.2f} in the reference pass; pool move (relocating "
        f"{res['relocated_by_pool_move']} streams) {res['set_prefill_s']:.3f}s, back to decode "
        f"{res['set_decode_s']:.3f}s, retirement {res['retire_s']:.3f}s; "
        + (f"chaos cell {res['chaos_reason']} fell back, its streams bit-equal to the "
           "reference; " if res["chaos_reason"] else "")
        + f"{res['pages_compared_bytes']} injected page bytes equal to the source's; peak device "
        + ", ".join(f"{k} {v:.2f}" for k, v in res["peak_device_gib"].items())
        + " GiB; attention launches " + ", ".join(f"{k} {v}" for k, v in res["launches"].items())
        + "; window graphs captured after start-up (count, s) " + ", ".join(
            f"{k} {v[0]} in {v[1]:.2f}s" for k, v in res["graphs_captured"].items())
        + f"; B's host seconds in the clean pass and pool move: inject {res['b_inject_s']:.3f}, "
        + ", ".join(f"{k} {v:.3f}" for k, v in res["b_phase_s"].items())
        + f"; exit codes {res['exit_codes']} ({card_line})")


# -- phase 15: multi-LoRA serving at llama-8b's widths --------------------------

LORA_SLOTS = 4
LORA_RANK = 16
# (name, rank, seed) of the six adapters, ranks 16 and 8: more adapters than
# bank slots, so a burst pages adapters in and evicts cold ones.
LORA_ADAPTERS = [(f"tenant-{k}", 16 if k % 2 == 0 else 8, 31 + k) for k in range(6)]
# The burst's rows that name an adapter (index into LORA_ADAPTERS); rows 0
# and 4 stay on the base model.
LORA_ROWS = {1: 0, 2: 1, 3: 2, 5: 3, 6: 4, 7: 5}
LORA_BASE_ROWS = [0, 4]
# Greedy adapter rows (rank 16 and rank 8) held to a forward whose q/k/v/o
# weights carry their adapter merged in float32; row 0 is held to the
# unmerged weights by the same harness, which prices the harness itself.
LORA_CHECK_ROWS = [1, 2]
# G2 blocks: the six adapters' factor pages (charged by their bytes in KV
# block units) and the burst's KV blocks fit at once.
LORA_HOST_BLOCKS = 1024
# Teacher-forced |logprob(engine) - logprob(reference)| per generated token.
# On an NVIDIA H100 80GB HBM3 at 700 W the sound rows read at most 0.0627
# (bf16) and 0.1247 (int8 weights and pages), the controls (an adapter row
# against the unmerged weights and against another adapter's merge) 4.6 to
# 7.5; the controls must read above the bound.
LORA_LP_TOL = {"float32": 1e-3, "bfloat16": 0.3}


def lora_argv() -> list[str]:
    """The worker flags of LORA_ADAPTERS."""
    out = ["--lora-slots", str(LORA_SLOTS), "--lora-rank", str(LORA_RANK)]
    for name, rank, seed in LORA_ADAPTERS:
        out += ["--lora", f"{name}:{rank}:{seed}"]
    return out


async def lora_phase(card_line: str, preset: str = "llama-8b", device: str = "cuda",
                     dtype: str = "bfloat16", quant: str = "none", kv_quant: str = "none",
                     model=None) -> dict:
    """Phase 15a: ``run``'s pipeline with an adapter bank of LORA_SLOTS
    slots at rank LORA_RANK and a G2 of LORA_HOST_BLOCKS blocks, the six
    LORA_ADAPTERS registered (written through to G2), one LocalPipeline per
    adapter card beside the base one on the same engine. The burst's 8
    prompts (top-2 logprobs): rows LORA_ROWS under their adapters, rows 0
    and 4 base, all sent at once, so that admissions wait for a slot and
    adapters page in from G2. Every pass starts from empty G1 and G2 KV
    (the adapters' pages are put back into G2), so every prefill is cold:

    - mixed at depth 2 and at depth 0: the 8 streams identical;
    - base-only (every row base): rows 0 and 4 bit-identical to the mixed
      pass's, every adapter row's logprobs different from its base run;
    - mixed with tree speculation (``--spec-tokens 3``, width 2, depth 3,
      unpipelined): verify passes carry adapter rows; a greedy stream
      leaves the dense mixed one only where the dense top-2 gap is under
      SPEC_GAP_TOL;
    - one adapter chat under GRAMMAR_RF: finishes stop and validates.

    Every pass holds attention launches to layers x (substeps + verify
    forwards), int8 calls to ``int8_expected`` plus 7 x layers + 1 per
    verify forward, and no window, step or verify pass eager on the card.
    Then LORA_CHECK_ROWS teacher-forced through a plain forward whose
    q/k/v/o weights carry the row's adapter merged in float32 (rounded to
    the compute dtype), every token within SPEC_GAP_TOL of that forward's
    top-1 and its logprob within LORA_LP_TOL; row 0 the same way on the
    unmerged weights. On the card, the LoRA window's replay against the
    pre-LoRA one (device ms and kernels per substep, graph == eager)."""
    import numpy as np
    import torch

    from dynamo_tpu_torch.engine.lora import adapter_bank_bytes, adapter_tier_hash
    from dynamo_tpu_torch.engine.lora import LoraAdapterSpec, make_adapter_pages
    from dynamo_tpu_torch.llm.protocols import ChatCompletionRequest, CompletionRequest
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
    from dynamo_tpu_torch.run.__main__ import LocalPipeline, parse_args
    from dynamo_tpu_torch.runtime.engine import Context
    from dynamo_tpu_torch.worker.__main__ import adapter_cards

    cuda = device == "cuda"
    tag = "lora" if quant == "none" else f"lora-int8-kv{kv_quant}"
    args = parse_args(["--in", "batch:-", "--preset", preset, "--dtype", dtype, "--device",
                       device, *ENGINE_ARGV, "--spec-ngram", str(SPEC_NGRAM)])
    t0 = time.perf_counter()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    pipe = await local_pipeline(args, quant=quant, kv_quant=kv_quant, model=model,
                                lora_slots=LORA_SLOTS, lora_rank=LORA_RANK,
                                host_kv_blocks=LORA_HOST_BLOCKS)
    engine, runner = pipe.engine, pipe.engine.runner
    cfg, L = engine.cfg, engine.cfg.num_layers
    pages = {}
    for name, rank, seed in LORA_ADAPTERS:
        engine.register_adapter(name, rank=rank, seed=seed)
        pages[name] = make_adapter_pages(cfg, LoraAdapterSpec(name=name, rank=rank, seed=seed),
                                         LORA_RANK)
    cards = adapter_cards(pipe.card, LORA_ADAPTERS)
    pipes = {i: LocalPipeline(cards[a], engine, ByteTokenizer()) for i, a in LORA_ROWS.items()}
    itemsize = torch.empty((), dtype=runner.dtype).element_size()
    result: dict = {"layers": L, "bank_bytes": adapter_bank_bytes(cfg, LORA_SLOTS, LORA_RANK,
                                                                  itemsize),
                    "adapter_page_bytes": sum(int(a.nbytes) for a in pages[LORA_ADAPTERS[0][0]]),
                    "graphs": {}}
    log(f"{tag}: {cfg.name} ({L} layers) pipeline up in {time.perf_counter() - t0:.1f}s, "
        f"{len(LORA_ADAPTERS)} adapters registered (ranks "
        f"{[r for _, r, _ in LORA_ADAPTERS]}, {result['adapter_page_bytes'] / 2**20:.1f} MiB of "
        f"f32 pages each at rank {LORA_RANK}), bank of {LORA_SLOTS} slots "
        f"{result['bank_bytes'] / 2**20:.1f} MiB ({card_line})")
    g = runner.graphs
    top = engine.args.top_logprobs_max
    if g is not None:
        # One warm-up, its new window graphs split by their key's LoRA flag.
        before = set(g.shapes)
        runner.warm_windows(("greedy", "simple"), (top,))
        for variant in (False, True):
            costs = [c for k, c in g.capture_costs().items()
                     if k not in before and k[6] is variant]
            result["graphs"]["lora" if variant else "base"] = {
                "graphs": len(costs), "capture_s": sum(c[0] for c in costs),
                "pool_bytes_added": sum(c[1] for c in costs)}
        gb, gl = result["graphs"]["base"], result["graphs"]["lora"]
        log(f"{tag}: window graphs without LoRA {gb['graphs']} in {gb['capture_s']:.2f}s "
            f"(+{gb['pool_bytes_added'] / 2**20:.1f} MiB pool), with LoRA {gl['graphs']} in "
            f"{gl['capture_s']:.2f}s (+{gl['pool_bytes_added'] / 2**20:.1f} MiB pool) "
            f"({card_line})")
    prompts = burst_prompts()
    greedy_rows = [i for i, t in enumerate(BURST_TEMPS) if t == 0.0]

    def fresh() -> None:
        """Empty G1 and G2 of KV (so every prefill is cold); the adapters'
        pages go back into G2."""
        engine.clear_kv_blocks()
        engine._drain_offload_fetches(force=True)
        engine.tiers.host.clear()
        for name, _r, _s in LORA_ADAPTERS:
            engine.tiers.put_object(adapter_tier_hash(name), *pages[name])

    def view(gen, t_first):
        return {"tokens": list(gen.lp_tokens), "logprobs": list(gen.lp_values),
                "tops": list(gen.lp_tops), "ttft_s": t_first, "resp": gen.final_response()}

    async def one(i, adapters):
        p = pipes[i] if adapters and i in pipes else pipe
        req = CompletionRequest.parse({
            "model": p.card.name, "prompt": prompts[i], "max_tokens": BURST_TOKENS,
            "temperature": BURST_TEMPS[i], "seed": 1000 + i, "ignore_eos": True,
            "logprobs": 2})
        t_start, t_first, gen = time.perf_counter(), None, None
        async for g_, _chunk in p.run(req, Context()):
            t_first = t_first if t_first is not None else time.perf_counter() - t_start
            gen = g_
        return view(gen, t_first)

    def counts0():
        zero_counts()
        return {"steps": engine.total_decode_steps, "prefilled": engine.total_prefilled,
                "passes": runner.verify_passes, "forwards": runner.verify_forwards,
                "eager": (runner.eager_windows, runner.eager_verifies, runner.eager_steps),
                "lora": dict(engine.lora_stats()), "pagein_s": engine.lora_pagein_s,
                "waits": (engine.lora_slot_waits, engine.lora_slot_wait_s),
                "g2_hits": engine.tiers.stats().get("g2_hits", 0),
                "tree": engine.total_spec_tree_passes,
                "vcalls": (runner.verify_calls, runner.tree_verify_calls)}

    def held_counts(label, c0, lens) -> dict:
        """Hold the pass's launch counts to its substeps and forwards → the
        pass's numbers."""
        launches = int8_counts()
        substeps = engine.total_decode_steps - c0["steps"]
        forwards = runner.verify_forwards - c0["forwards"]
        per_fwd = verify_per_forward(L, cuda, quant == "int8")
        want = (L * (substeps + forwards), 0, 0, 0)
        if quant == "int8":
            k, p, w = int8_expected(cfg, lens, substeps)
            want = (want[0], k, p, w + per_fwd[4] * forwards)
        if not cuda:
            want = (0, 0, 0, 0)
        if launches != want or substeps + forwards == 0:
            raise RuntimeError(f"{tag}[{label}]: launches (attention, int8 kernel, int8 prefill "
                               f"route, int8 wide entry) {launches} != {want} for {substeps} "
                               f"substeps and {forwards} verify forwards")
        # The verify passes' counted kernel calls, all and tree alone (each
        # pass one fused forward), held to their forwards: what the kernels
        # line reports for linear and tree verify.
        tree_passes = engine.total_spec_tree_passes - c0["tree"]
        vcalls, tcalls = (tuple(b - a for a, b in zip(c, now)) for c, now in zip(
            c0["vcalls"], (runner.verify_calls, runner.tree_verify_calls)))
        if (vcalls, tcalls) != (tuple(n * forwards for n in per_fwd),
                                tuple(n * tree_passes for n in per_fwd)):
            raise RuntimeError(f"{tag}[{label}]: verify passes made {vcalls} kernel calls "
                               f"({tcalls} in tree passes) for {forwards} forwards, "
                               f"{tree_passes} of them tree passes")
        eager = tuple(b - a for a, b in zip(c0["eager"], (runner.eager_windows,
                                                          runner.eager_verifies,
                                                          runner.eager_steps)))
        if cuda and any(eager):
            raise RuntimeError(f"{tag}[{label}]: windows, verify passes and steps run eagerly "
                               f"on the card: {eager}")
        st = engine.lora_stats()
        waits = engine.lora_slot_waits - c0["waits"][0]
        return {"launches": launches, "substeps": substeps, "verify_forwards": forwards,
                "verify_passes": runner.verify_passes - c0["passes"],
                "tree_passes": tree_passes,
                "verify_attention_launches": vcalls[0],
                "tree_verify_attention_launches": tcalls[0],
                "pageins": st["pageins"] - c0["lora"]["pageins"],
                "evictions": st["evictions"] - c0["lora"]["evictions"],
                "slot_hits": st["hits"] - c0["lora"]["hits"],
                "g2_hits": engine.tiers.stats().get("g2_hits", 0) - c0["g2_hits"],
                "pagein_s": engine.lora_pagein_s - c0["pagein_s"],
                "slot_waits": waits,
                "slot_wait_s": engine.lora_slot_wait_s - c0["waits"][1],
                "prefilled": engine.total_prefilled - c0["prefilled"]}

    async def burst(label, adapters=True):
        fresh()
        c0 = counts0()
        t1 = time.perf_counter()
        outs = await asyncio.gather(*(one(i, adapters) for i in range(len(prompts))))
        wall = time.perf_counter() - t1
        while engine.busy():
            await asyncio.sleep(0.001)
        for i, o in enumerate(outs):
            usage, choice = o["resp"]["usage"], o["resp"]["choices"][0]
            if usage["completion_tokens"] != BURST_TOKENS or choice["finish_reason"] != "length":
                raise RuntimeError(f"{tag}[{label}] request {i}: {usage['completion_tokens']} "
                                   f"tokens, finish {choice['finish_reason']!r}")
            if not all(np.isfinite(lp) and lp <= 0.0 for lp in o["logprobs"]) or not all(
                    0 <= t < cfg.vocab_size for t in o["tokens"]):
                raise RuntimeError(f"{tag}[{label}] request {i}: bad token/logprob stream")
        st = held_counts(label, c0, BURST_LENS)
        if st["prefilled"] != sum(BURST_LENS):
            raise RuntimeError(f"{tag}[{label}]: prefilled {st['prefilled']} tokens, not the "
                               f"cold burst's {sum(BURST_LENS)}")
        st.update(wall_s=wall, tokens_per_s=len(prompts) * BURST_TOKENS / wall,
                  ttft_s=[o["ttft_s"] for o in outs])
        log(f"{tag}[{label}]: 8 requests ({len(LORA_ROWS) if adapters else 0} under adapters) x "
            f"{BURST_TOKENS} tokens in {wall:.3f}s → {st['tokens_per_s']:.1f} tokens/s; "
            f"{st['substeps']} substeps, {st['verify_passes']} verify passes "
            f"({st['tree_passes']} branched); page-ins {st['pageins']} ({st['g2_hits']} G2 hits, "
            f"{1e3 * st['pagein_s'] / max(1, st['pageins']):.1f} ms each on the host), "
            f"evictions {st['evictions']}, {st['slot_waits']} admissions waited for a slot "
            f"{st['slot_wait_s']:.3f}s in all; launches (attention, int8 kernel, int8 prefill "
            f"route) {st['launches']} ({card_line})")
        return outs, st

    def same(a, b) -> bool:
        return a["tokens"] == b["tokens"] and a["logprobs"] == b["logprobs"] and \
            a["tops"] == b["tops"]

    mixed, result["mixed"] = await burst("mixed depth2")
    if result["mixed"]["pageins"] < len(LORA_ADAPTERS) or result["mixed"]["evictions"] < 1:
        raise RuntimeError(f"{tag}: the mixed burst paged in {result['mixed']['pageins']} "
                           f"adapters and evicted {result['mixed']['evictions']}")
    engine.args.pipeline_depth = 0
    mixed0, result["mixed_depth0"] = await burst("mixed depth0")
    engine.args.pipeline_depth = 2
    for i, (a, b) in enumerate(zip(mixed, mixed0)):
        if not same(a, b):
            raise RuntimeError(f"{tag}: request {i}: depth 2 and depth 0 streams differ")
    log(f"{tag}: all 8 streams (tokens, logprobs, top-2) identical at pipeline_depth 2 and 0")
    base, result["base_only"] = await burst("base-only", adapters=False)
    for i in LORA_BASE_ROWS:
        if not same(base[i], mixed[i]):
            raise RuntimeError(f"{tag}: base row {i} of the mixed burst differs from the "
                               "base-only burst")
    effect = {}
    for i in LORA_ROWS:
        if base[i]["logprobs"] == mixed[i]["logprobs"]:
            raise RuntimeError(f"{tag}: adapter row {i} equals its base run")
        p = _first_divergence(mixed[i]["tokens"], base[i]["tokens"])
        n = BURST_TOKENS if p is None else p
        effect[i] = {"first_token_divergence": p, "max_logprob_delta_before": max(
            (abs(a - b) for a, b in zip(mixed[i]["logprobs"][:n], base[i]["logprobs"][:n])),
            default=0.0)}
    result["adapter_effect"] = effect
    log(f"{tag}: base rows {LORA_BASE_ROWS} bit-identical between the mixed and base-only "
        f"bursts; every adapter row differs from its base run (first token divergence "
        f"{ {i: e['first_token_divergence'] for i, e in effect.items()} })")

    engine.set_spec(spec_tokens=SPEC_TOKENS, spec_gate=0.0, **SPEC_TREE)
    engine.args.pipeline_depth = 0
    tree, result["tree"] = await burst("tree")
    engine.set_spec(spec_tokens=0)
    engine.args.pipeline_depth = 2
    if result["tree"]["verify_passes"] == 0 or result["tree"]["tree_passes"] == 0:
        raise RuntimeError(f"{tag}: the tree burst dispatched {result['tree']['verify_passes']} "
                           f"verify passes, {result['tree']['tree_passes']} branched")
    if g is not None and not any(k[0] == "verify" and k[8] for k in g.shapes):
        raise RuntimeError(f"{tag}: no verify pass carried adapter rows")
    n_div, gaps = 0, []
    for i in greedy_rows:
        p = _first_divergence(tree[i]["tokens"], mixed[i]["tokens"])
        if p is None:
            continue
        tops = sorted((lp for _tok, lp in mixed[i]["tops"][p]), reverse=True)
        if tops[0] - tops[1] >= SPEC_GAP_TOL:
            raise RuntimeError(f"{tag}: tree greedy row {i} leaves the dense mixed stream at "
                               f"token {p}, where its top-2 gap is {tops[0] - tops[1]:.4f}")
        n_div += 1
        gaps.append(tops[0] - tops[1])
    result["tree"]["divergences"], result["tree"]["gaps"] = n_div, gaps
    log(f"{tag}: tree burst: {n_div} of {len(greedy_rows)} greedy streams leave the dense "
        f"mixed ones, each where the dense top-2 gap is under {SPEC_GAP_TOL} ({gaps})")

    # One adapter chat under the schema: masked single steps with the LoRA
    # rows' slots.
    fresh()
    c0 = counts0()
    chat = ChatCompletionRequest.parse(grammar_chat(1, prompts, pipes[1].card.name))
    gen = None
    async for g_, _chunk in pipes[1].run(chat, Context()):
        gen = g_
    while engine.busy():
        await asyncio.sleep(0.001)
    body = gen.final_response()
    choice = body["choices"][0]
    if choice["finish_reason"] != "stop":
        raise RuntimeError(f"{tag}: the adapter's schema chat finished "
                           f"{choice['finish_reason']!r}")
    obj = grammar_valid(choice["message"]["content"])
    prefilled = engine.total_prefilled - c0["prefilled"]
    result["grammar"] = held_counts("grammar", c0, [prefilled])
    result["grammar"]["tokens"] = body["usage"]["completion_tokens"]
    log(f"{tag}: a {LORA_ADAPTERS[LORA_ROWS[1]][0]} chat under the schema finished stop in "
        f"{result['grammar']['tokens']} tokens and validates ({obj}); "
        f"{result['grammar']['substeps']} masked single steps with the adapter's slot")

    # The adapter rows against merged weights, row 0 against the unmerged.
    result["reference"], result["reference_controls"] = lora_reference(engine, mixed, tag, dtype,
                                                                       card_line)
    if cuda:
        result["timing"] = lora_timing(engine, card_line, tag)
        result["max_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        result["graph_pool_bytes"] = g.pool_bytes()
        log(f"{tag}: peak device memory {result['max_mem_gib']:.2f} GiB, graph pool "
            f"{g.pool_bytes() / 2**20:.1f} MiB ({card_line})")
    result["lora_stats"] = engine.lora_stats()
    await engine.stop()
    del pipe, pipes, engine, runner
    if cuda:
        torch.cuda.empty_cache()
    return result


def lora_reference(engine, outs: list[dict], tag: str, dtype: str,
                   card_line: str) -> tuple[dict, dict]:
    """Teacher-forced references of the mixed burst's rows, op by op
    outside the engine: the prompt's prefill, then one decode step per
    generated token fed the engine's token. LORA_CHECK_ROWS run on the
    engine's weights with their adapter merged into q/k/v/o in float32
    (dequantized int8 weights included) and rounded to the compute dtype;
    row 0 on the unmerged weights. Each emitted token must be within
    SPEC_GAP_TOL of the reference's top-1 logprob and its logprob within
    LORA_LP_TOL of the engine's. Controls: the first check row's stream
    against the other check row's merge and against the unmerged weights
    must leave LORA_LP_TOL, so the bound is shown to tell adapters apart.
    → (readings by row, the controls' readings)."""
    import torch

    from dynamo_tpu_torch.engine import model as M
    from dynamo_tpu_torch.engine.lora import LoraAdapterSpec, make_adapter_pages

    cfg, params = engine.cfg, engine.runner.params
    dev, dt = engine.runner.device, engine.runner.dtype
    bs = engine.args.block_size
    prompts = burst_prompts()
    tol = LORA_LP_TOL[dtype]

    def merged(name: str, rank: int, seed: int) -> dict:
        pages = make_adapter_pages(cfg, LoraAdapterSpec(name=name, rank=rank, seed=seed),
                                   LORA_RANK)
        layers = dict(params["layers"])
        for j, key in enumerate(("wq", "wk", "wv", "wo")):
            a = torch.from_numpy(pages[2 * j]).to(dev)
            b = torch.from_numpy(pages[2 * j + 1]).to(dev)
            w = layers[key].float()
            if layers[key].dtype == torch.int8:
                w = w * layers.pop(key + "_scale").float()[:, None, :]
            layers[key] = (w + torch.bmm(a, b)).to(dt)
        return dict(params, layers=layers)

    def forced(p: dict, i: int) -> tuple[float, float]:
        ids, gen = list(prompts[i].encode()), outs[i]["tokens"]
        T = len(ids)
        nb = -(-(T + len(gen)) // bs)
        cache = M.init_kv_cache(cfg, nb + 1, bs, dt, dev, kv_quant=engine.args.kv_quant)
        table = torch.arange(1, nb + 1, dtype=torch.int32, device=dev)
        toks = torch.zeros((-(-T // bs) * bs,), dtype=torch.int32, device=dev)
        toks[:T] = torch.tensor(ids, dtype=torch.int32, device=dev)
        logits = M.prefill(cfg, p, cache, toks, table, 0, T)
        drift, worst_gap = 0.0, 0.0
        for k, t in enumerate(gen):
            lp = torch.log_softmax(logits.float(), dim=-1)
            drift = max(drift, abs(float(lp[t]) - outs[i]["logprobs"][k]))
            worst_gap = max(worst_gap, float(lp.max() - lp[t]))
            if k + 1 < len(gen):
                logits = M.decode_step(
                    cfg, p, cache, torch.tensor([t], dtype=torch.int32, device=dev),
                    torch.tensor([T + k], dtype=torch.int32, device=dev), table[None],
                    torch.ones((1,), dtype=torch.bool, device=dev))[0]
        return drift, worst_gap

    out, controls = {}, {}
    for i in [*LORA_CHECK_ROWS, 0]:
        if i in LORA_ROWS:
            name, rank, seed = LORA_ADAPTERS[LORA_ROWS[i]]
            p, what = merged(name, rank, seed), f"{name} (rank {rank}) merged"
        else:
            p, what = params, "the unmerged weights"
        drift, gap = forced(p, i)
        out[i] = {"max_logprob_delta": drift, "worst_top1_gap": gap}
        log(f"{tag}: row {i} teacher-forced on {what}: max |logprob - engine| {drift:.4g} "
            f"(bound {tol}), every token within {gap:.4g} of the reference's top-1 (bound "
            f"{SPEC_GAP_TOL}) ({card_line})")
        if drift > tol or gap > SPEC_GAP_TOL:
            raise RuntimeError(f"{tag}: row {i} against its reference on {what}: max |logprob "
                               f"delta| {drift:.4g}, worst top-1 gap {gap:.4g}")
        c = LORA_CHECK_ROWS[0]
        if i != c:
            cdrift, cgap = forced(p, c)
            controls[f"row {c} on {what}"] = {
                "max_logprob_delta": cdrift, "worst_top1_gap": cgap}
            log(f"{tag}: control: row {c} teacher-forced on {what}: max |logprob - engine| "
                f"{cdrift:.4g}, worst top-1 gap {cgap:.4g} (must leave the bound {tol}) "
                f"({card_line})")
            if cdrift <= tol:
                raise RuntimeError(f"{tag}: control row {c} on {what} stays within the logprob "
                                   f"bound ({cdrift:.4g} <= {tol}): the bound does not tell "
                                   "adapters apart")
        del p
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out, controls


def lora_timing(engine, card_line: str, tag: str) -> dict:
    """The "simple" window at the burst's lengths on the engine's weights
    and adapter bank (its own small cache), as the pre-LoRA and as the LoRA
    graph (five adapter rows, one base): the LoRA replay bit-identical to
    op by op, each replay's device time per substep and one profiled
    replay of each by kernel family."""
    import numpy as np

    from dynamo_tpu_torch.engine.config import EngineArgs
    from dynamo_tpu_torch.engine.runner import LocalRunner

    args = EngineArgs(model=engine.cfg, block_size=16, num_kv_blocks=256, max_num_seqs=8,
                      max_model_len=2048, decode_steps=8, dtype="bfloat16", device="cuda",
                      kv_quant=engine.args.kv_quant, lora_slots=LORA_SLOTS, lora_rank=LORA_RANK)
    runner = LocalRunner(args, params=engine.runner.params)
    runner.start()
    runner.lora_bank = engine.runner.lora_bank  # the uploaded adapters, before any capture
    kw = dict(window_inputs(runner, "simple", 61, lens=BURST_HIST[:6]), top_n=0)
    kw_lora = dict(kw, adapter_slots=np.array([0, 1, 2, 3, -1, 0, -1, -1], np.int32))
    graph_vs_eager(runner, kw_lora)
    base_ms, lora_ms = replay_ms(runner, kw), replay_ms(runner, kw_lora)
    pb, pl = profile_replay(runner, kw, card_line), profile_replay(runner, kw_lora, card_line)
    runner.stop()
    out = {"replay_ms_per_substep": {"base": base_ms, "lora": lora_ms},
           "kernels_per_substep": {"base": pb["kernels_per_substep"],
                                   "lora": pl["kernels_per_substep"]},
           "profile": {"base": pb, "lora": pl}}
    log(f"{tag}: simple window at the burst's lengths, graph replay == op by op with 5 adapter "
        f"rows; device ms per substep {base_ms:.3f} without LoRA, {lora_ms:.3f} with "
        f"({lora_ms - base_ms:+.3f}); kernels per substep {pb['kernels_per_substep']:.0f} → "
        f"{pl['kernels_per_substep']:.0f} (+{pl['kernels_per_substep'] - pb['kernels_per_substep']:.0f}"
        f" for the delta) ({card_line})")
    return out


def lora_worker_phase(card_line: str, model_path: str, device: str = "cuda",
                      dtype: str = "bfloat16") -> dict:
    """Phase 15b: the store, one ``python -m dynamo_tpu_torch.worker
    --model-path <dir> --tokenizer byte --disagg off`` with LORA_ADAPTERS
    (``lora_argv``) and a kv-mode frontend. /v1/models lists the base model
    and every adapter with its lora metadata; row 1 under its adapter and
    row 0 on the base model, each as an aggregate completion (token texts
    and logprobs bit-equal to an in-process engine on the same checkpoint
    with the same adapters) and, after /clear_kv_blocks, as an SSE stream
    (the same text, [DONE]). The worker's attention launches are layers x
    its substeps, it paged adapters in, and every process exits 0."""
    from dynamo_tpu_torch.engine.loader import load_config

    cfg = load_config(model_path)
    model = cfg.name
    procs: list[Proc] = []
    store_port = _free_port()
    store_url = f"tcp://127.0.0.1:{store_port}"
    try:
        store = Proc("lora-store", ["dynamo_tpu_torch.runtime.store_server", "--host",
                                    "127.0.0.1", "--port", str(store_port)])
        procs.append(store)
        store.wait_for(r"store server: tcp://", 60)
        worker = Proc("lora-worker", [
            "dynamo_tpu_torch.worker", "--store-url", store_url, "--model-path", model_path,
            "--tokenizer", "byte", "--dtype", dtype, "--device", device, "--disagg", "off",
            *lora_argv(), *ENGINE_ARGV])
        procs.append(worker)
        # The in-process reference runs while the worker starts.
        ref = asyncio.run(_lora_worker_reference(model_path, device, dtype))
        m, secs = worker.wait_for(r"worker: serving .* \((\d+) window graphs captured in "
                                  r"([0-9.]+)s", 600)
        log(f"lora-worker: registered {secs:.2f}s after launch, {m.group(1)} window graphs "
            f"(with and without LoRA) in {m.group(2)}s ({card_line})")
        fe = Proc("lora-frontend", ["dynamo_tpu_torch.frontend", "--store-url", store_url,
                                    "--host", "127.0.0.1", "--port", "0", "--router-mode", "kv"])
        procs.append(fe)
        port = int(fe.wait_for(r"frontend: http://127\.0\.0\.1:(\d+)", 120)[0].group(1))
        got = asyncio.run(_lora_http(port, model))
        for label, i in (("adapter", 1), ("base", 0)):
            _check_disagg(f"lora-worker {label} row {i} aggregate", got[label]["aggregate"],
                          ref[i])
            s = got[label]["sse"]
            if s["status"] != 200 or s.get("error") or not s["done"] or s["text"] != ref[i]["text"]:
                raise RuntimeError(f"lora-worker {label} row {i} SSE: status {s['status']} "
                                   f"{s.get('error')}, [DONE] {s['done']}, text "
                                   f"{'equal' if s.get('text') == ref[i]['text'] else 'differs'}")
        c = usr1_counters(worker)
        want = cfg.num_layers * c["decode_substeps"] if device == "cuda" else 0
        if c["paged_attention_launches"] != want or c["eager_windows"] or \
                c["lora"]["pageins"] < 1:
            raise RuntimeError(f"lora-worker: attention launches {c['paged_attention_launches']} "
                               f"(want {want}), eager windows {c['eager_windows']}, lora "
                               f"{c['lora']}")
        rcs = {p.name: p.stop() for p in [fe, worker, store]}
        if any(rcs.values()):
            raise RuntimeError(f"lora-worker: processes did not exit 0 on SIGTERM: {rcs}")
        log(f"lora-worker: /v1/models lists {model} and {len(LORA_ADAPTERS)} adapters; the "
            f"adapter and the base request, aggregate and SSE, equal the in-process engine on "
            f"the same checkpoint (token texts and logprobs bit for bit); worker lora "
            f"{c['lora']}, attention launches {c['paged_attention_launches']} = "
            f"{cfg.num_layers} x {c['decode_substeps']} ({card_line})")
        return {"models": got["models"], "counters_lora": c["lora"],
                "launches": c["paged_attention_launches"],
                "decode_substeps": c["decode_substeps"], "launch_to_registered_s": secs,
                "exit_codes": rcs}
    finally:
        for p in procs:
            p.kill()


async def _lora_worker_reference(model_path: str, device: str, dtype: str) -> dict:
    """Rows 1 (under its adapter) and 0 (base) in process on the checkpoint
    with the worker's engine arguments and adapters, one at a time, cold →
    reference entries by row."""
    from dynamo_tpu_torch.llm.protocols import CompletionRequest
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
    from dynamo_tpu_torch.run.__main__ import LocalPipeline, parse_args
    from dynamo_tpu_torch.runtime.engine import Context
    from dynamo_tpu_torch.worker.__main__ import adapter_cards

    args = parse_args(["--in", "batch:-", "--model-path", model_path, "--tokenizer", "byte",
                       "--dtype", dtype, "--device", device, *ENGINE_ARGV])
    pipe = await local_pipeline(args, lora_slots=LORA_SLOTS, lora_rank=LORA_RANK)
    engine = pipe.engine
    for name, rank, seed in LORA_ADAPTERS:
        engine.register_adapter(name, rank=rank, seed=seed)
    cards = adapter_cards(pipe.card, LORA_ADAPTERS)
    await asyncio.to_thread(engine.runner.warm_windows, ("greedy", "simple"))
    prompts = burst_prompts()
    refs = {}
    try:
        for i in (1, 0):
            p = LocalPipeline(cards[LORA_ROWS[i]], engine, ByteTokenizer()) if i in LORA_ROWS \
                else pipe
            req = CompletionRequest.parse({
                "model": p.card.name, "prompt": prompts[i], "max_tokens": BURST_TOKENS,
                "temperature": BURST_TEMPS[i], "seed": 1000 + i, "ignore_eos": True,
                "logprobs": 0})
            gen = None
            async for g, _chunk in p.run(req, Context()):
                gen = g
            refs[i] = reference_entry(gen, 0.0)
            engine.clear_kv_blocks()
    finally:
        await engine.stop()
    return refs


async def _lora_http(port: int, model: str) -> dict:
    """/v1/models until the base model and every adapter are listed, then
    rows 1 (adapter) and 0 (base), each aggregate and, after a cache
    clear, as SSE."""
    want = {model} | {name for name, _r, _s in LORA_ADAPTERS}
    listed = {}
    for _ in range(600):
        _, _, pieces, _ = await http_request(port, "/v1/models", method="GET")
        listed = {m["id"]: m for m in json.loads(b"".join(p for _, p in pieces))["data"]}
        if set(listed) == want:
            break
        await asyncio.sleep(0.1)
    else:
        raise RuntimeError(f"lora-worker: the frontend lists {sorted(listed)}, not {sorted(want)}")
    for name, rank, _seed in LORA_ADAPTERS:
        if listed[name].get("lora") != {"adapter_id": name, "base": model, "rank": rank,
                                        "resident_tier": "G2"}:
            raise RuntimeError(f"lora-worker: /v1/models entry of {name}: {listed[name]}")
    if "lora" in listed[model]:
        raise RuntimeError(f"lora-worker: the base model's entry carries lora: {listed[model]}")
    prompts = burst_prompts()
    out = {"models": sorted(want)}
    for label, i, name in (("adapter", 1, LORA_ADAPTERS[LORA_ROWS[1]][0]), ("base", 0, model)):
        body = {"model": name, "prompt": prompts[i], "max_tokens": BURST_TOKENS,
                "temperature": BURST_TEMPS[i], "seed": 1000 + i, "ignore_eos": True,
                "logprobs": 0}
        agg = await http_completion(port, dict(body, stream=False), f"{0x1500 + 2 * i:032x}")
        await clear_kv(port, model, workers=1)
        sse = await http_completion(port, dict(body, stream=True), f"{0x1501 + 2 * i:032x}")
        await clear_kv(port, model, workers=1)
        out[label] = {"aggregate": agg, "sse": sse}
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs a GPU",
              file=sys.stderr)
        return 2
    try:
        from dynamo_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the dynamo_tpu_torch package is not beside this script ({e})",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: torch {torch.__version__} (CUDA {torch.version.cuda}), {kind}; nvidia-smi: {card_line}")

    # Wall seconds of each phase, logged at the end: the script must finish
    # within the chip run's limit, and these say where the time goes.
    phase_s: dict[str, float] = {}
    t_phase = [time.perf_counter()]

    def mark(name: str) -> None:
        now = time.perf_counter()
        phase_s[name] = round(now - t_phase[0], 1)
        t_phase[0] = now
        log(f"phase {name}: {phase_s[name]:.1f}s (total {now - t_start:.1f}s)")

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"build: {len(libs)} kernel source(s) built in {time.perf_counter() - t0:.1f}s → "
        f"{', '.join(str(v) for v in libs.values())}")
    if sys.argv[1:] == ["--tp-nccl"]:
        return tp_nccl_main(card_line)

    mark("1-2 build")
    cases = kernel_phase(device)
    int8_cases, int8_substeps = int8_kernel_phase(device, card_line)
    tied_cases = tied_head_phase(device, card_line)
    mark("3 kernels")
    stats, reference = asyncio.run(main_path(card_line))
    int8_runs, int8_refs = {}, {}
    for kv_quant in ("none", "int8"):
        int8_runs[kv_quant], int8_refs[kv_quant] = asyncio.run(
            main_path(card_line, quant="int8", kv_quant=kv_quant, wide=kv_quant == "none"))
        torch.cuda.empty_cache()
    for kv_quant, st in int8_runs.items():
        log(f"int8 vs bf16 ({kv_quant} KV pages for int8): tokens/s {st['tokens_per_s']:.1f} vs "
            f"{stats['tokens_per_s']:.1f}, host ms per substep {st['substep_ms']:.3f} vs "
            f"{stats['substep_ms']:.3f}, simple replay {st['replay_ms_per_substep_simple']:.3f} "
            f"vs {stats['replay_ms_per_substep_simple']:.3f} ms per substep, peak memory "
            f"{st['max_mem_gib']:.2f} vs {stats['max_mem_gib']:.2f} GiB, graph pool "
            f"{st['graph_pool_bytes'] / 2**20:.1f} vs {stats['graph_pool_bytes'] / 2**20:.1f} MiB "
            f"({card_line})")
    mark("4 main path")
    par = parallel_phase(card_line)
    mark("4p pipeline, ring attention, ep")
    tied = asyncio.run(tied_phase(card_line))
    torch.cuda.empty_cache()
    mark("4d tied")
    moe = asyncio.run(moe_phase(card_line))
    torch.cuda.empty_cache()
    mark("4e moe")
    small_reference(device)
    frames = msgpack_frame_us()
    log("wire: msgpack_lite pack+unpack per frame: " + ", ".join(
        f"{k} {v['us']:.1f} us ({v['bytes']} bytes)" for k, v in frames.items())
        + f" (host CPU beside {card_line})")
    spans_us = span_record_us()
    log(f"tracing: one request's three engine spans through the histogram and exporter sinks "
        f"{spans_us:.1f} us on an uncontended thread (host CPU beside {card_line})")
    torch.cuda.empty_cache()
    try:
        http = http_phase(card_line, reference, stats["tokens_per_s"], fleet=True,
                          sla_profile=stats["sweep"]["path"], control={})
    finally:
        shutil.rmtree(os.path.dirname(stats["sweep"]["path"]), ignore_errors=True)
    http["msgpack_lite"] = frames
    http["span_record_us"] = spans_us
    mark("5-7c http, fleet and control plane")
    ckpt = checkpoint_phase(card_line, keep=True)
    mark("8 checkpoint")
    tok = tokenizer_phase(card_line, ckpt.pop("path"), ckpt.pop("cfg"))
    mark("9 tokenizer")
    torch.cuda.empty_cache()
    # Phases 10-15 at CUT_LAYERS layers of llama-8b's widths: in process
    # from seed 0, and in workers from a checkpoint of the same weights.
    cut = cut_config("llama-8b", CUT_LAYERS)
    shallow, _, _, shallow_bytes, shallow_s = write_checkpoint("llama-8b", CUT_LAYERS)
    mark("10- checkpoint of the cut model")
    shallow_weights = ["--model-path", shallow, "--tokenizer", "byte"]
    tp = {"bf16": tp_phase(card_line, lambda: asyncio.run(burst_reference(shallow_weights)),
                           model_path=shallow)}
    torch.cuda.empty_cache()
    tp["int8"] = tp_phase(card_line, lambda: asyncio.run(burst_reference(
        shallow_weights, quant="int8", kv_quant="int8", lora=True)), quant="int8",
        kv_quant="int8", model_path=shallow, lora=True)
    torch.cuda.empty_cache()
    mark("4t tensor parallel")
    spec = {"bf16": asyncio.run(spec_phase(card_line, model=cut))}
    spec["int8"] = asyncio.run(spec_phase(card_line, quant="int8", kv_quant="int8", model=cut))
    for name, st in spec.items():
        t = st["timing"]
        log(f"spec[{name}]: tokens/s dense {st['dense']['tokens_per_s']:.1f}, fused "
            f"{st['fused']['tokens_per_s']:.1f}, stepwise {st['stepwise']['tokens_per_s']:.1f}, "
            f"tree {st['tree']['tokens_per_s']:.1f}; tokens per weight pass fused "
            f"{st['fused']['tokens_per_weight_pass']:.3f}, tree "
            f"{st['tree']['tokens_per_weight_pass']:.3f}; verify replay S1=4 "
            f"{t['linear_S1_4_ms']:.3f} / S1=7 {t['linear_S1_7_ms']:.3f} ms (tree "
            f"{t['tree_S1_4_ms']:.3f} / {t['tree_S1_7_ms']:.3f}) against a dense substep "
            f"{t['dense_substep_ms']:.3f} ms ({card_line})")
    mark("10 spec")
    torch.cuda.empty_cache()
    wire = kv_wire_timing()
    log(f"kv wire: one {wire['bytes']}-byte chunk (47 llama-8b bf16 blocks) in {wire['frames']} "
        f"frames of at most {wire['max_frame']} bytes: one copy {wire['memcpy_s'] * 1e3:.1f} ms; "
        + "; ".join(f"{name} {wire[k] * 1e3:.1f} ms ({wire[k] / wire['memcpy_s']:.2f} copies)"
                    for name, k in (("frame + pack", "pack_s"), ("unpack + assemble", "unpack_s"),
                                    ("to_wire", "to_wire_s"),
                                    ("endpoint → router over TCP", "runtime_s")))
        + f" (host CPU beside {card_line})")
    disagg = {"kv_wire": wire}
    # One chaos cell, as in phase 14: the int8 pass runs without the cut.
    for name, q in (("bf16", "none"), ("int8", "int8")):
        disagg[name] = disagg_phase(
            card_line, lambda q=q: asyncio.run(checkpoint_reference(shallow, quant=q, kv_quant=q)),
            quant=q, kv_quant=q, model_path=shallow, chaos=name == "bf16")
        torch.cuda.empty_cache()
    mark("11 disagg")

    torch.cuda.empty_cache()
    grammar, grammar_ref = {}, None
    grammar["bf16"], grammar_ref = asyncio.run(grammar_phase(card_line, model=cut))
    grammar["int8"], _ = asyncio.run(grammar_phase(card_line, quant="int8", kv_quant="int8",
                                                   model=cut))
    for name, st in grammar.items():
        t = st["timing"]
        log(f"grammar[{name}]: constrained tokens/s dense {st['dense']['tokens_per_s']:.1f}, tree "
            f"{st['tree']['tokens_per_s']:.1f} (phase 4's unconstrained burst "
            f"{(stats if name == 'bf16' else int8_runs['int8'])['tokens_per_s']:.1f}); masked step "
            f"{t['step_masked_ms']:.3f} ms vs unmasked {t['step_unmasked_ms']:.3f} and a dense "
            f"substep {t['dense_substep_ms']:.3f}; engine_grammar_mask_seconds over the dense "
            f"burst {st['dense']['mask_s'] * 1e3:.2f} ms ({card_line})")
    torch.cuda.empty_cache()
    grammar["http"] = grammar_http_phase(card_line, grammar_ref, model_path=shallow)
    grammar["lift"] = grammar_lift_phase(card_line)
    mark("12 grammar")

    torch.cuda.empty_cache()
    tiers = {"bf16": tiers_phase(card_line, model_path=shallow)}
    tiers["bf16_workers"] = tiers_worker_phase(card_line, tiers["bf16"].pop("hit_reference"),
                                               model_path=shallow)
    tiers["int8"] = tiers_phase(card_line, quant="int8", kv_quant="int8", model_path=shallow)
    tiers["int8_workers"] = tiers_worker_phase(card_line, tiers["int8"].pop("hit_reference"),
                                               quant="int8", kv_quant="int8", model_path=shallow)
    mark("13 tiers")

    torch.cuda.empty_cache()
    migration = {"bf16": migration_phase(card_line, model_path=shallow)}
    # One chaos cell: the int8 pass runs without C.
    migration["int8"] = migration_phase(card_line, quant="int8", kv_quant="int8", chaos=False,
                                        model_path=shallow)
    mark("14 migration")

    torch.cuda.empty_cache()
    lora = {"bf16": asyncio.run(lora_phase(card_line, model=cut))}
    torch.cuda.empty_cache()
    lora["int8"] = asyncio.run(lora_phase(card_line, quant="int8", kv_quant="int8", model=cut))
    torch.cuda.empty_cache()
    lora["worker"] = lora_worker_phase(card_line, shallow)
    for name in ("bf16", "int8"):
        st = lora[name]
        t = st["timing"]
        log(f"lora[{name}]: {st['layers']} layers: tokens/s mixed "
            f"{st['mixed']['tokens_per_s']:.1f} against base-only "
            f"{st['base_only']['tokens_per_s']:.1f}; "
            f"replay ms per substep {t['replay_ms_per_substep']['lora']:.3f} with the LoRA "
            f"variant, {t['replay_ms_per_substep']['base']:.3f} without; kernels per substep "
            f"+{t['kernels_per_substep']['lora'] - t['kernels_per_substep']['base']:.0f}; bank "
            f"{st['bank_bytes'] / 2**20:.1f} MiB; page-ins {st['mixed']['pageins']} at "
            f"{1e3 * st['mixed']['pagein_s'] / max(1, st['mixed']['pageins']):.1f} ms from G2; "
            f"slot wait {st['mixed']['slot_wait_s']:.3f}s over {st['mixed']['slot_waits']} "
            f"admissions; peak memory {st['max_mem_gib']:.2f} GiB ({card_line})")
    shutil.rmtree(shallow, ignore_errors=True)
    mark("15 lora")

    head = cases[0]  # decode on bf16 pages: the main path's mode
    burst = next(r for r in cases if r["case"] == "decode_bfloat16_burst")
    entry = {
        "name": "paged_attention", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "version": KERNEL_VERSION, "splits": burst["splits"],
        "launches": stats["launches"], "launches_http": http["launches"],
        "launches_fleet": http["fleet"]["launches"],
        "launches_sweep": stats["sweep"]["launches"],
        "launches_planner": http["control"]["launches"],
        "launches_tokenizer_worker": tok["launches"][0],
        "launches_disagg_decode_worker": disagg["bf16"]["launches"][0],
        "launches_disagg_decode_worker_int8": disagg["int8"]["launches"][0],
        "launches_grammar_single_steps": sum(
            grammar["bf16"][b]["attention_launches"] for b in ("dense", "dense_repeat")),
        "launches_grammar_single_steps_int8": sum(
            grammar["int8"][b]["attention_launches"] for b in ("dense", "dense_repeat")),
        "launches_grammar_worker": grammar["http"]["counters"]["paged_attention_launches"],
        "launches_tiers": sum(tiers["bf16"]["launches"][k][0] for k in ("cold", "hit", "g2")),
        "launches_tiers_int8": sum(tiers["int8"]["launches"][k][0]
                                   for k in ("cold", "hit", "g2")),
        "launches_migration_workers": sum(migration["bf16"]["launches"].values()),
        "launches_migration_workers_int8": sum(migration["int8"]["launches"].values()),
        "launches_lora": sum(lora["bf16"][b]["launches"][0]
                             for b in ("mixed", "mixed_depth0", "base_only", "grammar")),
        "launches_lora_int8": sum(lora["int8"][b]["launches"][0]
                                  for b in ("mixed", "mixed_depth0", "base_only", "grammar")),
        "launches_lora_worker": lora["worker"]["launches"],
        "launches_moe": moe["launches"][0] + moe["depth0"]["launches"][0],
        "launches_tp_ranks": tp["bf16"]["launches"],
        "launches_tp_ranks_int8": tp["int8"]["launches"],
        "launches_tp_ranks_int8_adapter_rows": tp["int8"]["lora"]["launches"],
        "launches_ep_ranks": par["ep"]["launches"],
        "max_abs_err": head["max_abs_err"], "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "cases": cases,
    }
    i8 = next(r for r in int8_cases if r["case"] == "w_gate_up_M8_bfloat16")
    int8_entry = {
        "name": "int8_matmul", "route": "cuda", "source": INT8_SOURCE,
        "replaces": INT8_REPLACES, "launches": int8_runs["none"]["int8_launches"],
        "prefill_route_launches": int8_runs["none"]["int8_prefill_launches"],
        "launches_kv_int8": int8_runs["int8"]["int8_launches"],
        "launches_checkpoint_worker": ckpt["launches"][1],
        "launches_tokenizer_worker": tok["launches"][1],
        "launches_disagg_decode_worker": disagg["int8"]["launches"][1],
        "prefill_route_launches_disagg_prefill_worker": disagg["int8"]["prefill_launches"][2],
        "launches_grammar": sum(grammar["int8"][b]["int8_launches"]
                                for b in ("dense", "tree", "dense_repeat")),
        "launches_tiers": sum(tiers["int8"]["launches"][k][1] for k in ("cold", "hit", "g2")),
        "launches_migration_workers": sum(migration["int8"]["int8_launches"].values()),
        "launches_lora": sum(lora["int8"][b]["launches"][1]
                             for b in ("mixed", "mixed_depth0", "base_only", "tree", "grammar")),
        "launches_tp_ranks": [r[0] for r in tp["int8"]["int8_launches"]],
        "max_abs_err": i8["max_abs_err"], "ms": i8["ms"], "plain_ms": i8["plain_ms"],
        "bound_ms": i8["bound_ms"], "bound_by": i8["bound_by"], "library_ms": i8["library_ms"],
        "case": i8["case"], "substep_225_calls": int8_substeps, "cases": int8_cases,
    }
    gu8 = next(r for r in int8_cases if r["case"] == "group_gate_up_M8_bfloat16")
    decode_entry = {
        "name": "int8_matmul_decode", "route": "cuda", "source": INT8_SOURCE,
        "replaces": INT8_REPLACES, "version": INT8_DECODE_VERSION,
        "launches": int8_runs["none"]["int8_decode_launches"],
        "products": int8_runs["none"]["int8_launches"],
        "launches_kv_int8": int8_runs["int8"]["int8_decode_launches"],
        "max_abs_err": gu8["max_abs_err"], "ms": gu8["ms"], "plain_ms": gu8["plain_ms"],
        "bound_ms": gu8["bound_ms"], "bound_by": gu8["bound_by"],
        "library_ms": gu8["library_ms"], "split_k_ms": gu8["split_k_ms"], "case": gu8["case"],
        "cases": [r for r in int8_cases if r["case"].startswith("group_")
                  or (r["M"] <= 8 and r["route"] == "kernel" and r["case"].endswith("bfloat16")
                      and "odd" not in r["case"])],
        "substep_225_grouped": {k: v for k, v in int8_substeps.items()
                                if "grouped" in str(k)},
    }
    wide = int8_runs["none"]["wide"]
    w32 = next(r for r in int8_cases if r["case"] == "w_gate_up_M32_bfloat16")
    wide_entry = {
        "name": "int8_matmul_wide", "route": "cuda", "source": INT8_SOURCE,
        "replaces": INT8_REPLACES, "launches": wide["launches"][3],
        "launches_main_path_int8": int8_runs["none"]["int8_wide_launches"],
        "launches_kv_int8": int8_runs["int8"]["int8_wide_launches"],
        "launches_checkpoint_worker": ckpt["launches"][3],
        "launches_tokenizer_worker": tok["launches"][3],
        "launches_spec_int8": sum(spec["int8"][b]["int8_wide_launches"]
                                  for b in ("dense", "fused", "stepwise", "tree")),
        "launches_disagg_workers": disagg["int8"]["launches"][3]
        + disagg["int8"]["prefill_launches"][3],
        "launches_grammar": sum(grammar["int8"][b]["int8_wide_launches"]
                                for b in ("dense", "tree", "dense_repeat")),
        "launches_tiers": sum(tiers["int8"]["launches"][k][3] for k in ("cold", "hit", "g2")),
        "launches_migration_workers": sum(migration["int8"]["int8_wide_launches"].values()),
        "launches_lora": sum(lora["int8"][b]["launches"][3]
                             for b in ("mixed", "mixed_depth0", "base_only", "tree", "grammar")),
        "launches_tp_ranks": [r[1] for r in tp["int8"]["int8_launches"]],
        "max_abs_err": w32["max_abs_err"], "ms": w32["ms"], "plain_ms": w32["plain_ms"],
        "bound_ms": w32["bound_ms"], "bound_by": w32["bound_by"],
        "library_ms": w32["library_ms"], "dequant_ms": w32["dequant_ms"], "case": w32["case"],
        "substeps_by_bucket": wide["substeps_by_bucket"],
    }
    # Modes 3 and 4 on the path: the speculative verify passes of phase 10
    # (bf16 run); times from phase 3's cases at the burst's lengths, T=4.
    spec_entries = []
    for mode in ("linear", "tree"):
        r = next(c for c in cases if c["case"] == f"{mode}_T4_bfloat16_burst")
        def counted(runs):
            """Counted attention launches of this mode's verify passes."""
            tree = sum(runs[b]["tree_verify_attention_launches"] for b in ("fused", "tree"))
            return tree if mode == "tree" else sum(
                runs[b]["verify_attention_launches"] for b in ("fused", "tree")) - tree

        grammar_tree = {
            "launches_grammar": grammar["bf16"]["tree"]["verify_attention_launches"],
            "launches_grammar_int8": grammar["int8"]["tree"]["verify_attention_launches"],
        } if mode == "tree" else {}
        lt = lora["bf16"]["tree"]
        grammar_tree["launches_lora"] = lt["tree_verify_attention_launches"] if mode == "tree" \
            else lt["verify_attention_launches"] - lt["tree_verify_attention_launches"]
        spec_entries.append({
            **grammar_tree,
            "name": f"paged_attention_{mode}_verify", "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": KERNEL_REPLACES, "version": KERNEL_VERSION,
            "launches": counted(spec["bf16"]), "launches_int8_run": counted(spec["int8"]),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "case": r["case"],
        })
    t8 = next(r for r in tied_cases if r["case"] == "tied_llama-3b_M8_bfloat16")
    tied_entry = {
        "name": "int8_matmul_tied_head", "route": "cuda", "source": INT8_SOURCE,
        "replaces": TIED_REPLACES, "launches": tied["launches"][4],
        "launches_substeps": tied["substeps"], "launches_prefills": tied["forwards"]
        - tied["substeps"], "substeps_by_bucket": tied["substeps_by_bucket"],
        "max_abs_err": t8["max_abs_err"], "ms": t8["ms"], "plain_ms": t8["plain_ms"],
        "bound_ms": t8["bound_ms"], "bound_by": t8["bound_by"],
        "library_ms": t8["library_ms"], "dequant_ms": t8["dequant_ms"], "case": t8["case"],
        "cases": tied_cases,
    }
    log("main_path: " + json.dumps(stats))
    for kv_quant, st in int8_runs.items():
        log(f"main_path_int8_kv{kv_quant}: " + json.dumps(st))
    log("tied_path: " + json.dumps(tied, default=str))
    log("moe_path: " + json.dumps(moe, default=str))
    log("tp_path: " + json.dumps(tp))
    log("parallel_path: " + json.dumps(par))
    log("http_path: " + json.dumps(http))
    log("checkpoint_path: " + json.dumps(ckpt))
    log("tokenizer_path: " + json.dumps(tok))
    log("spec_path: " + json.dumps(spec))
    log("disagg_path: " + json.dumps(disagg))
    log("grammar_path: " + json.dumps(grammar))
    log("tiers_path: " + json.dumps(tiers))
    log("migration_path: " + json.dumps(migration))
    log("lora_path: " + json.dumps(lora, default=str))
    log(f"cut model: {cut.name}, checkpoint {shallow_bytes / 1e9:.2f} GB written in "
        f"{shallow_s:.1f}s")
    log("phase wall seconds: " + json.dumps(phase_s))
    log("moe: " + json.dumps({
        "model": moe["model"], "tokens_per_s": moe["tokens_per_s"],
        "host_ms_per_substep": moe["host_ms_per_substep"], "prefill_s": moe["prefill_s"],
        "replay_ms_per_substep": moe["replay_ms_per_substep"],
        "moe_ms_per_layer": {b: a["ms_per_layer"] for b, a in moe["alone"].items()},
        "moe_share_of_replay": {b: a["share_of_replay"] for b, a in moe["alone"].items()
                                if "share_of_replay" in a},
        "dense_bound_ms": moe["dense_bound_ms"], "routed_bound_ms": moe["routed_bound_ms"],
        "check": moe["check"], "max_mem_gib": moe["max_mem_gib"],
        "graph_pool_bytes": moe["graph_pool_bytes"], "card": card_line}))
    log(f"chip_smoke: phases 1-15 passed in {time.perf_counter() - t_start:.1f}s ({card_line})")
    print(json.dumps({"kernels": [entry, int8_entry, decode_entry, wide_entry, tied_entry,
                                  *spec_entries]}), flush=True)
    print(card_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
