#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero. Every
serving trace (4-5d) dispatches through CUDA graphs, the engine's default
(``launch/graphs.py``: one graph per shape key, captured at first use and
replayed; the kernels' launch counts include the replays); the instruments
(finite logits, the captured verify dispatch) read each dispatch through the
graph cache's tap, replays included, and every timed trace runs after
``warm()`` and must keep one decode specialization (none on speculative
engines, whose target only verifies) and add no ``prefill_slots`` one:

1. device: needs CUDA; prints the card's name and power limit, turns off
   TF32 and reduced-precision bf16 reductions in matrix products;
2. build: compiles the port's CUDA kernels from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, all at once), prints each prefill and channel
   block kernel's registers, shared memory and spills (the other
   libraries': their registers and largest spill), and checks that the
   ``flash_prefill`` and ``flash_suffix_prefill`` libraries hold
   tensor-core wgmma (``HGMMA``) and TMA-load (``UTMALDG``) instructions,
   and the ``topk_compress`` and ``quantize`` libraries warp reductions
   (``REDUX``) and no block barrier (``BAR``);
3. kernels vs plain: each kernel against its plain PyTorch version on the
   card, at the serving path's shapes (stablelm-1.6b: Hkv 32, G 1, hd 64,
   bf16, page 16, scattered tables with shared pages and scratch tails), at
   a GQA shape (G 4, hd 128) and in float32. Planted faults (the plain
   version with its mask shifted by one key, or without its last live
   page) must land outside the tolerance. Times the kernel, the plain
   version and one PyTorch library call (``scaled_dot_product_attention``
   over the same K/V, gathered up to each row's live span — a yardstick
   only, the port never calls it) as device time from the profiler's
   kernel rows, and the wrapper's wall time per call. ``flash_prefill``
   also at the ring path's cold round (B 4, S = T = 8192, window 4096):
   device times against SDPA with the windowed causal mask, the bound over
   the live (query, key) pairs, no plain time (its fp32 scores: 34 GB),
   and the timed output against the plain version one row and 8 kv heads
   at a time, one-ulp flips of the bf16 outputs left out of the error.
   ``paged_decode`` (a split-KV kernel, ``csrc/decode.cuh``) also prints
   its launch (keys per range by ``paged_decode.split_len``, ranges per row,
   blocks launched and with a live range), and each of its 8 rows run
   alone must give bitwise the row's output in the batch;
3b. int8 kernels: the int8-pool decode and suffix kernels at the same
   shapes over int8 pools, within the tolerance of their plain versions
   AND bitwise equal to the fp kernels over the dequantized pool; planted
   faults (a scale read from the wrong token slot; the pool dequantized
   without rounding to q's dtype where that moves the output beyond the
   tolerance, else every scale read from the wrong kv head; the last live
   page dropped) must land outside it. ``kv_write_int8`` (one layer's int8
   pool write: K and V quantized per token per kv head, q and scale stored
   in their page slots) bitwise equal to its plain version on every plane
   outside scratch page 0 (dead decode rows may collide there, in no defined
   order) at a decode step's write (8 slots x 32 kv heads, hd 64, bf16), at
   the int8 main path's suffix round, on wrapped rings with dead rows on
   page 0 (float32, hd 32), with a row of length 0, and on rows longer than
   their rings; planted faults (the slot off by one, the scale divided by
   128) must differ. The first two are timed. ``int8_encode`` (the
   flat encoder, ``ops.int8_encode_leaf``) bitwise equal to its plain
   version (q and scale) at the embedding leaf (205,520,896 elements, rows
   of 256), with a planted fault (divisor 128). Times as in 3; the library
   call is ``scaled_dot_product_attention`` over the K/V dequantized
   beforehand (none for the two quantizers). ``paged_decode_int8``'s launch
   is printed and its rows are held alone against the batch (bitwise) at
   the path shape, as in 3;
3c. ring kernels: ``paged_decode_ring`` (dead pages skipped) and
   ``swa_decode`` (every slot) against their plain versions and BITWISE
   against each other (the former at every page of 64-512 keys; the table
   kernel over the same keys in pool pages too) at the
   ring path's shape (B 4, Hkv 32, hd 64, bf16, C 4096, window 4096, two
   rows short of the ring, two wrapped), long_500k's (B 1, C 8192, pos
   524287), the single-batch path's (B 4, hd 64, bf16, C = window = 96:
   one ring page of 96 keys, streamed as a 64-key tile and a 32-key tail;
   every row wrapped, a scalar position and per-row ones) and a GQA shape
   (G 4, hd 128, bf16 and f32, a scalar position, window 1000 < C);
   planted faults (a mask shifted by one key, the ring
   offset without the mod wrap, the last live page dropped) must land
   outside the tolerance. Each shape prints the split-KV launch of both
   kernels (keys per range, ranges per row, blocks launched and with a
   live range); at the ring path's shape each row run alone must give
   bitwise its output in the batch, for both ring kernels and the table
   kernel over the same keys. Times as in 3 at the first two shapes, and
   the table kernel's over the same keys in pool pages of 16 there; the
   library call runs over the rings unrolled to position order; the
   kernels' bounds count the K and V of each row's live span (what the
   function needs), ``swa_decode``'s log line also the bytes it streams;
3d. verify kernels: ``suffix_prefill`` and ``suffix_prefill_int8`` at the
   speculative k-token verify's shape (8 rows of S 8, 1..5 live queries,
   starts at every offset within a page of 16, prefixes of 64-415 tokens
   sharing 4 pages, the engine's prefix-width bucket) against their plain
   versions, the int8 kernel also bitwise against the fp kernel over the
   dequantized pool; planted faults (the last prefix key or page dropped, a
   scale from the next slot) must differ. Timed as in 3, SDPA over the same
   keys as the library call; the bounds count the live queries only;
3e. tensor-parallel kernels ([tp-kernels]): ``paged_decode``,
   ``paged_decode_int8``, ``suffix_prefill``, ``suffix_prefill_int8`` and
   ``flash_prefill`` at the per-shard shapes of 2 and 4 shards (Hkv 16 and
   8) on the main path's inputs of 3: each shard against its plain version
   and BITWISE equal to its heads of the Hkv-32 launch; device times at
   Hkv 32, 16 and 8;
3f. the other configs' shapes ([shapes]): every attention kernel
   (``paged_decode``, ``paged_decode_int8``, ``paged_decode_ring``,
   ``swa_decode``, ``flash_prefill``, ``suffix_prefill``,
   ``suffix_prefill_int8``, ``kv_write_int8``) at hd 160 / G 4 / Hkv 8
   (stablelm-12b), hd 128 / G 3 / Hkv 8 (phi4-mini), G 2 at hd 32 and the
   padded hd 30 (phi4-mini's smoke layer, at the kernels' 32 with the scale
   30**-0.5, held against the plain version unpadded), bf16 and float32:
   within ``RTOL`` of the plain versions (planted faults outside), the int8
   kernels bitwise the fp kernels over the dequantized pool, the table,
   ring and ``swa_decode`` kernels bitwise equal over the same keys, each
   decode row alone bitwise its row in the batch, ``kv_write_int8`` bitwise
   its plain version outside scratch page 0; at hd 160 and at G 3 in bf16,
   at the main path's shapes, each kernel's device time beside its bound,
   its plain version's and SDPA's (``enable_gqa``) where one call computes
   the same function;
3g. recurrentgemma-2b's local attention ([hd256]): ``flash_prefill`` (B 4,
   S 4096, window 2048), ``paged_decode_ring`` and ``swa_decode`` (B 8, C
   2048, rows short of the ring and wrapped) at hd 256, G 10, Hkv 1, bf16
   and float32, within ``RTOL`` of the plain versions (bf16 prefill:
   one-ulp flips of the outputs left out), the ring kernels bitwise equal,
   planted faults outside; bf16 timed (device and wrapper ms, the plain
   version's, SDPA's with ``enable_gqa``, the bound); phase 2 prints the
   hd-256 instantiations' registers and spills;
3w-3x, 5w. whisper-medium's attention ([whisper-kernels]): ``flash_prefill``'s
   non-causal mode at B 4, Hkv 16, G 1, hd 64 over T 1500 frames, with S =
   1500 queries (the encoder, 3w), 64 (the prefill's cross-attention, 3x)
   and 1, in bf16 (tensor cores) and float32 (SIMT): within ``RTOL`` of the
   plain version (bf16: one-ulp flips left out), planted faults (the causal
   mask applied; the last key dropped, T - 1 keys) outside;
   ``swa_decode`` and ``paged_decode_ring`` over a ring of C 1500 at pos
   1499 (the decode step's cross-attention: every slot live, one page of
   the whole ring) within ``RTOL`` and BITWISE equal, faults outside; bf16
   timed (device and wrapper ms, the plain version's, SDPA's with
   ``is_causal=False``, the bound);
3p, 2p. the per-request path's shapes ([per-request]): ``flash_prefill`` at B
   1 (S 384 causal; S 6144 with window 4096, a ring prompt past its
   window) and ``suffix_prefill`` at width 1 (an exact 45-token suffix
   behind 256 cached tokens, W 16), bf16: within ``RTOL`` of the plain
   versions (one-ulp flips left out), planted faults outside; timed as in
   3g, SDPA over the same keys;
4. golden: the port's engine replays the reference engine's float32 greedy
   trace (``src/repro_torch/testdata/golden_stablelm_smoke.json``) and must
   reproduce its tokens exactly;
4b. golden int8: the same for the reference's int8 + host-tier trace
   (``golden_stablelm_smoke_int8_swap.json``: int8 pages, prefix cache, a
   pool that preempts, a host tier that swaps and demotes/promotes); tokens
   and the counters (preemptions, pages swapped out and in, pages demoted,
   promote hits, prefill tokens, CoW copies) must be the reference's;
4c. golden ring: the reference's float32 ring-mode trace
   (``golden_stablelm_smoke_ring.json``: the ring engine chunked with a
   window its prompts wrap, interleaved, with paged decode off; the
   windowed paged engine; the windowed single-batch path): every token;
4d. golden speculative: the reference's float32 speculative traces
   (``golden_stablelm_smoke_spec.json``: the shared-prefix trace with k = 3
   under a same-params and a foreign draft, on fp and on int8 pages): tokens,
   finish reasons and the round counters exactly, the tokens also the
   reference's plain engine's; the verify and the draft's kernels launched;
4e. golden router: the reference router's float32 traces
   (``golden_stablelm_smoke_router.json``: 2 replicas over tight fp pools with
   prefix sharing, arrivals over 9 rounds of a virtual clock advanced once
   per router round, a priority pair, a deadline; replica 1 killed with no
   host tier, every migrated request re-prefilled, and stalled with tiers of
   32 pages, live slots carrying their pages): tokens, finish reasons, the
   shed record, the router's counters, each replica's preemptions, swaps
   and slot history exactly;
4f. golden training: the reference trainer's float32 traces
   (``golden_train_smoke.json``: the smoke config on the bridged weights, 2
   clouds with sample counts (30, 10), H = 2, 6 steps of 2 x 16, int8 with
   error feedback and DP clip 0.5, no noise) under fedavg, dynamic,
   gradient, async, fedavg with the nesterov outer optimizer and fedavg at
   2 microbatches, replayed through the channel kernels (leaves down to 128
   elements, under one 256-block): per-step per-cloud losses within rtol
   1e-4 and the final global params' per-leaf sum and sum of squares within
   1e-2 of the leaf's RMS per element (``golden_train_errors``); the planted
   fault, the sample counts ignored, must land outside in the fedavg and
   gradient cases; and the pod case (the reference's pod-mode step on a
   2-device pod mesh: topk+int8 through the SPMD codecs, ``wire_int8``,
   4 steps), replayed on a pod mesh naming the card twice, its fault caught
   by the checksums;
4g. golden tensor-parallel ([tp-golden]): the reference engine's float32
   traces of 4 and 4c's four engine runs served on meshes of 2 and 4 shards
   on the card (graphed): every token, every kernel of the paths launched;
4h. golden configs ([golden-configs]): the reference engine's float32
   traces of stablelm-12b, mistral-nemo-12b, phi4-mini-3.8b (head dim 30,
   padded) and olmoe-1b-7b (MoE, a padded width bucket) at their smoke
   configs, replayed through CUDA graphs: tokens and pool counters
   identical, every serving kernel launched;
4i. golden recurrent ([golden-recurrent]): the reference's float32 traces
   of the recurrent families: the single batch of xlstm-125m and of
   recurrentgemma-2b (window 8, wrapped) through ``generate_batch``'s
   decode graph, the engine trace of the stablelm-1.6b smoke target with an
   xlstm-125m draft (tokens and counters identical), both families' FedAvg
   training (losses within ``GOLDEN_TRAIN_RTOL``);
4j. golden pixtral and whisper ([golden-vlm-audio]): the reference's
   float32 traces (``golden_vlm_audio_smoke.json``: numpy-seeded weights,
   audio and patches): whisper's single batch (window 0, and 6 that its
   prompts wrap) and pixtral's (from its tokens alone, as the reference's
   ``serve_batch``) through ``generate_batch``'s decode graph, whisper's
   prefill (the encoder and the prompt) and pixtral's (16 patches and the
   prompt) then greedy decode: every token, the kernels launched;
4k. golden per request ([golden-per-request]): the reference engine's
   float32 traces with ``batch_prefill=False``
   (``golden_stablelm_smoke_per_request.json``: rings with a window its
   prompts wrap, through ``prefill_slot``; the pool with prefix hits,
   width-1 cold and suffix dispatches; int8 pages in a pool that preempts):
   tokens, dispatch counters and ``compiles`` identical, each path's kernels
   launched;
   dry run ([dryrun]): the whole table of ``repro_torch.launch.dryrun``
   (10 architectures x 4 input shapes x 2 production meshes; a process of
   its own beside the build, no device, joined before the first timed
   phase so that no timed phase shares the host with it): 80 records, no error,
   every counted field filled (FLOPs, bytes, temporaries, collectives, the
   roofline terms) and only the compiler-only ones null, its wall, and
   stablelm-1.6b's eight records; then stablelm-1.6b's training record on a
   one-device logical mesh at phase 7's per-cloud shape (8 x 256):
   ``argument_bytes`` equal to the bytes of the parameters, AdamW state and
   batch the trainer holds on the card, exactly, beside the caching
   allocator's growth; then the counted cost of the real training (8 x
   256), prefill (8 x 512) and decode (8 rows) steps on the card: FLOPs
   equal to the meta count, ``temp_bytes`` within its set tolerance of the
   allocator's peak growth, the device time beside the roofline terms;
5. main path: ``ServeEngine`` over stablelm-1.6b at its published widths
   (24 layers, bf16, seeded random weights), 8 slots, page 16, prefix cache
   on: 8 cold prompts, then 8 prompts sharing a 256-token prefix; checks
   every request, finite logits, cold and suffix dispatches, a prefix hit
   rate > 0 and that every kernel launched; re-runs a cold round, a decode
   step and a suffix round through the plain versions (and through the
   planted faults) from the kernel run's cache and compares logits;
   EOS: the cold group again on that engine with ``eos_id`` a token the
   greedy trace emits: every request ends at its first EOS ("eos") or its
   budget ("length"), with the greedy trace's tokens;
5e. speculative main path: phase 5's trace with k = 4 under a same-params
   draft and a foreign-seed draft on fp pages, and the same-params draft on
   int8 pages: budgets, finite logits, one verify dispatch's logits at every
   live position against the plain path (and planted faults), no page left
   but the prefix index's, ``spec_emitted`` = tokens - first tokens, 24
   suffix-prefill launches per verify and suffix admission, the draft's
   ring decode and re-sync prefill launched. Printed beside phase 5's plain
   trace: tok/s, TTFT p50, target dispatches per token, acceptance, token
   agreement;
5f. sampled serving: phase 5's trace at temperature 0.8, top-k 40, top-p
   0.95 (request r on seed 1000 + r), plain and with the same-params draft:
   a second run and a run submitted in reverse order (other slots, other
   neighbours) give the same tokens; greedy odd uids beside sampled even
   ones keep the greedy trace's tokens. Printed without a gate: the plain
   trace over 4 slots (other batch widths, whose bf16 GEMMs may round
   otherwise). The batched sampler's law over 16384 draws of one verify
   logit row within 0.05 total variation of softmax(filter_logits(row));
5i. router: phase 5's 16 requests arriving 20 ms apart, served in real time
   by ``ServeRouter`` over 2 replicas of phase 5's engine with host tiers of
   256 pages, sharing one params dict: fault-free, kill:1@8, stall:1@8,
   slow:1@4@0.05, a sampled pair (fault-free, kill:1@8), and kill:1@8 over
   replicas without a tier (every migrated request re-prefills). Gates:
   every request finishes, none is shed, kill and stall record one
   migration; a faulted run's tokens are its fault-free run's for every
   request that did not re-prefill its history (those are printed: in bf16
   the prefill's K/V are not the decode step's), also where a request was
   admitted in rounds of other shapes (counted apart); device memory grows
   by less than one params' size from one replica to two. The same runs at
   the smoke config in float32 gate every request, the re-prefilled ones
   too.
   Printed per run: tok/s, TTFT and latency p50 from arrival,
   ``router_stats``, each replica's ``compiles`` and graph pool, the
   first-use captures inside the trace, the kernels' launches;
5j. lifecycle, one engine at full width on a virtual clock: a dry pool
   preempts the old priority -1 request (at priority 0: the youngest); a
   swapped mid-prompt victim past its deadline is shed and its tier entry
   released; ``max_wall_s`` retires a slot with "timeout" and publishes
   none of its pages; 4 mid-decode requests (greedy and sampled) exported
   with their pages and imported by a second engine continue token for
   token; ``prefix_probe`` changes no counter, refcount or LRU order;
5k. tensor-parallel main path ([tp-main]): first the per-shard projections'
   column slices against the full product's columns (bitwise or not);
   then, for meshes of 2 and 4 shards on the card: the cold round, a decode
   step and the suffix round of the sharded forward against the unsharded
   one (logits within 0.1 x scale), and phase 5's trace through a graphed
   sharded engine: counters (steps, prefill tokens, dispatches, prefix
   hits, CoW) and ``compiles`` equal to phase 5's, every serving kernel
   launched, 24 x shards ``paged_decode`` launches per decode step, token
   streams identical where the column slices are bitwise (else their share
   printed); tok/s, TTFT p50, the decode step's profile, pool bytes per
   shard;
5l. tensor-parallel int8 ([tp-int8]): 5b's int8 trace over a pool that
   preempts, without the host tier, at 2 shards against the unsharded
   engine: counters equal, tokens as in 5k, every int8 kernel launched, 48
   ``kv_write_int8`` launches per decode step;
5m. the other configs at their published widths ([configs-main]), one
   model on the card at a time (bf16, random weights from a seeded
   generator, nothing cut): stablelm-12b (hd 160, G 4) on fp and on int8
   pages, phi4-mini-3.8b (G 3, tied, vocab 200,064), mistral-nemo-12b
   (rope theta 1e6, vocab 131,072) and olmoe-1b-7b (64 experts, top 8):
   the cold round, a decode step and the suffix round against the plain
   versions in bf16 (logits within 0.1 x scale, 0.03 for an MoE model,
   planted faults outside)
   and in float32 (1e-3 x scale; the 12 B configs over their first 8 of 40
   layers, printed as a cut: a float32 copy of every layer would not fit
   beside the bf16 weights), an MoE model's plain runs on the kernel run's
   routing, then
   phase 5's trace through CUDA graphs: budgets, finite logits, every
   serving kernel launched; tok/s, TTFT p50, the decode step's profile, the
   pool's bytes per token, peak memory;
5n. the recurrent families at their published widths ([recurrent-main]):
   recurrentgemma-2b (26 layers, hd 256, G 10, vocab 256,000; bf16, seeded
   random weights): the single batch 4 x 64 + 64 at window 96, a 4 x 4096
   prefill (the rings of 2048 wrap) and 32 decode steps through the kernels
   against the plain versions (bf16 logits within 0.1 x scale, planted
   faults outside; float32 over every layer within 1e-3 x scale); xlstm-125m
   (12 layers): the single batch and a prefill with decode steps, finite
   logits;
5o. pixtral and whisper at their published widths ([vlm-audio-main]; bf16,
   seeded random weights, audio and patches): whisper-medium's single batch
   (4 x 64 + 64 over 1500 frames) through its decode graph (the encoder
   wall, tok/s, the eager decode step's device time and launches, peak
   memory), then a prefill and 16 decode steps through the kernels against
   the plain versions (bf16 logits within 0.1 x scale, the causal mask in
   the encoder outside; float32 over every layer within 1e-3 x scale, the
   last frame dropped outside); pixtral-12b's prefill of 256 patches + 64
   tokens and 32 decode steps, kernels against plain (bf16 within 0.1 x
   scale, the causal mask dropped outside; float32 over 8 of 40 layers,
   printed as a cut, within 1e-3 x scale, the mask shifted by one outside).
   Then [train-vlm-audio]: one loss, backward and AdamW step taken twice on
   one batch for whisper-medium whole and pixtral-12b over 4 of 40 layers
   (printed as a cut): finite losses and parameters, the loss drops;
5b. int8 main path: the same model over an int8 pool with a host tier; 8
   cold prompts of 256-384 tokens x 64 tokens in a pool tight enough that
   slots are preempted and swapped out, then 8 shared-prefix prompts x 32
   tokens. Checks every request's budget, swapped-in == swapped-out pages
   > 0, no re-prefill of a swapped slot (prefill tokens == lookup tokens -
   hit tokens), more prefill without the tier, no swap entry left on the
   tier, cold and suffix dispatches, every int8 kernel launched, no
   ``int8_encode`` launch, each decode step's pool written by exactly
   n_layers (24) ``kv_write_int8`` launches, and kernel-vs-plain logits on
   an int8 cache (with planted faults). Prints,
   without a gate, a second tier / no-tier pair (alternating with the
   first), the same trace over an ample int8 pool and an fp pool (token
   agreement, pool bytes per token, resident sequences at equal bytes),
   each run's throughput/TTFT/latency, and the int8 decode step's host
   wall, device time, launches and idle share. The kernels line's
   ``kv_write_int8`` row is the decode step's pool write (8 x 32 head rows
   of 64), the shape of almost all its launches; ``int8_encode``'s is the
   embedding leaf's, and its launches are 0: no main path runs the flat
   encoder any more;
5c. ring main path: stablelm-1.6b at its published widths over 4 slots of
   4096-slot rings (window 4096, 3.2 GB), chunked prefill, prompts of
   6144/5000/2048/700/300/96 tokens x 32: budgets, finite logits,
   ``paged_decode_ring`` and ``flash_prefill`` launched, one decode step's
   logits over two wrapped and two short rows (kernel vs plain, the two
   ring kernels bitwise, planted faults). Printed: the trace with paged decode off
   (``swa_decode``), the decode step's profile for both, the trace over
   the windowed paged pool (token agreement), an interleaved trace (4
   prompts of <= 64 tokens x 16);
5p. per request ([per-request-main]): phase 5's paged trace and 5c's ring
   trace with ``batch_prefill=False`` at full width: budgets, finite logits,
   one prefill dispatch per request, the kernels launched; tok/s, TTFT p50,
   dispatches, ``compiles`` and token agreement beside the batched traces'
   (no gate on bf16 tokens). The first-token logits of a 6144- and a
   700-token ring prompt through ``prefill_slot`` and of a width-1 cold and
   suffix dispatch within 0.1 x scale of the plain path (planted faults
   outside); in float32 four ring prompts' per-request logits within 1e-3 x
   scale of one batched cold round's;
5d. single batch: ``generate_batch`` at full width, batch 4, prompt 64, gen
   64, window 96 (the ring wraps; its shape is checked in 3c), through its
   one decode-and-argmax graph; ``swa_decode`` must launch;
5g. graphs against eager dispatch (run inside 5, 5b, 5c, 5d, 5e and 5f):
   the fp trace, the int8 + host-tier trace, the ring trace, the
   same-params speculative trace and the sampled trace again on engines
   with ``graphs=False``, and the single batch with every step eager:
   tokens, the engine's counters, the kernels' launches (the graphed run's
   accounted from its replays) and ``compiles`` must be bitwise equal.
   Printed per trace, graphed and eager: tok/s, TTFT p50, the speculative
   round's host wall, the decode step's host wall, device time and idle
   share, ``compiles`` and the graph pool's bytes;
5h. a planted fault: an engine over a model whose decode calls ``.item()``
   must raise at the decode graph's capture (no eager fallback); with
   ``graphs=False`` the same model serves;
6. channel kernels: top-k, int8, the DP norm and clip/noise against their
   plain versions on the card at the training path's leaves (the embedding,
   100352 x 2048, and one stacked MLP leaf, 24 x 2048 x 5632, fp32, k = 3):
   bitwise (the norm within 1e-6 relative), each with a planted fault that
   must fail its check; clip/noise also in bf16 and on a view 4 bytes off
   a 16-byte boundary, the norm also in bf16 and twice (equal bits). Top-k
   and int8 also bitwise on the sync's kind of update (a bf16-grid
   difference times a clip scale, ``channel_cases.py`` beside this
   script) and on it with edge blocks planted (all zeros, 1 or 2 nonzeros at k = 3, int8 half
   steps of the scale), whole, at a ragged length (n = 1,000,077) and as a
   view 4 bytes on; the planted faults there (top-k keeping exactly k per
   block, int8 rounding half away from zero, where the data holds half
   steps, else the divisor 128) must differ. Times at the embedding leaf,
   each with its kernels' device time one by one and its time by CUDA
   events back to back, and beside the rows top-k and int8 on the
   bf16-grid update, the clip alone (sigma 0, against ``torch.mul``) and
   the bf16 norm (against ``torch.linalg.vector_norm``, whose square is the
   function);
7. training: ``run_training`` over stablelm-1.6b at its published widths
   (2 clouds, H = 2, 4 steps, batch 8 x 256 per cloud, topk+int8 with error
   feedback, DP clip 1.0 and noise 0.1, FedAvg): finite losses, every
   channel kernel launched, local-step and sync-round times, the sync's
   device time by stage, the idle share of a local step, the device time of
   the DP kernels in a local step and in the sync, peak memory; then
   one sync round from a copy of the trained state through the kernels and
   through the plain versions (and two planted faults: top-k keeping k - 1,
   and exactly k, per block) with the same noise seed, whose new global
   parameters must agree; last, a second, untimed run of the same
   configuration and seed logs its first sync's share of blocks whose k-th
   magnitude is tied at the embedding leaves (embed.tok, embed.unembed).
   Printed beside the run: the modelled WAN wall of one sync round
   (``core/protocols.py``: TCP, gRPC and QUIC, star and ring) at the
   measured uplink bytes and at the uncompressed update's;
7b. the other aggregators at the same settings: gradient (every cloud's
   params equal the global params bitwise after every step), async (in each
   sync the cloud that did not arrive keeps its params bitwise, the arrived
   one holds the new global), fedavg with the nesterov outer optimizer (the
   momentum finite and nonzero after each sync) and dynamic; each with
   finite losses, every channel kernel launched, its steady local-step
   wall, tokens/s, sync walls and peak memory; async, nesterov and dynamic
   also with phase 7's kernel-vs-plain sync round from a copy of the state
   (a live ``loss_accum``, a mask with a late cloud);
7d. secure aggregation on the two clouds' fp32 deltas at 7b's dynamic
   run's first sync (their params copied to the host there, outside the
   run's timings, and taken up after the run), raw and DP-clipped, one
   leaf at a time: ``secure_aggregate`` bitwise
   ``from_fixed(sum to_fixed)``, a masked transmit equal to its fixed-point
   update on at most 8 of 1.64e9 elements, planted faults (a pair's mask
   with the wrong sign, a cloud on the next round) that must not cancel; its
   time and relative L2 error against the fp32 sum;
7c. microbatches: one local step at full width, ``microbatches=2`` against
   ``=1`` on 7b's trained params: the loss and each fp32 gradient leaf
   within 0.05 relative L2, the planted fault (the halves summed, not
   divided) outside; peak memory of both;
7e. checkpoint: the bf16 global params saved in the reference's format
   under ``build/`` and restored bitwise; save and restore walls, bytes on
   disk; the directory removed;
7f. pod mode ([pod-train]): phase 7's load in pod mode (2 pods on the one
   card, the SPMD codecs, ``wire_int8``): finite losses, the first sync's
   int8-wire aggregate within 0.03 of each leaf's max magnitude of the
   dense average of the same updates, the DP kernels launched and the
   block channel kernels not; losses, walls, peak memory, payload bytes;
7g. recurrent training ([train-recurrent]; run right after 2, in a process
   of its own, on a card nothing else has used yet): phase 7's load on
   recurrentgemma-2b (published widths, 3 of 26 layers) and xlstm-125m
   (published widths): finite losses, the channel kernels launched, a
   kernel sync equal to the plain sync; local-step walls, peak memory;
7h. ``dp_transmit`` ([dp-transmit]; run right after 7g, as is 7i): over
   stablelm-1.6b's whole parameter tree, bitwise the plain clip and noise from the kernel's norm at stddev 0
   and 0.1 on the same draws, its Σx² within 1e-5 of the plain sum's, the
   device time of one call;
7i. the examples ([examples]): the four torch examples (quickstart,
   federated LM, long-context decode, continuous serving), each in a
   process of its own on the card, all at once (before phases 3-7f leave
   the allocator holding most of the card), each exiting 0; the
   continuous-serving example's tokens identical to the single-batch
   oracle's;
8. a ``{"kernels": [...]}`` line (thirteen kernels: launches from the fp
   main path, the int8 main path, the ring main path (``swa_decode``'s from
   its paged-decode-off run, at the shape 3c times), the speculative traces
   of 5e (the verify's suffix prefills, the draft's ring decode and re-sync
   prefills, the int8 verify's pool writes), the tensor-parallel traces of
   5k-5l, the other configs' traces of 5m, the recurrent families' runs of
   5n, pixtral's and whisper's of 5o, the per-request traces of 5p, the
   training run and 7g),
   then ``{"ok": true, "device": {...}}`` last.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import gc
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
DEVICE = "cuda"
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak
# Kernel vs plain: max abs err relative to the RMS of the plain output. bf16:
# both sides round the output to bf16, so they may differ by one bf16 ulp
# (2**-7 relative) of an element a few times the RMS. float32: summation
# order over a few hundred keys (~1e-7 relative per add). On an H100 the
# sound bf16 readings were <= 0.024 and the planted faults >= 1.7.
RTOL = {"bfloat16": 0.05, "float32": 1e-4}
# Kernel vs plain logits at full width, relative to the logit scale. In
# float32 the two differ only in summation order: 1e-3 leaves room for 24
# layers of growth. In bf16 a one-ulp difference in one attention output
# grows through 24 random-weight layers: on an H100 the sound readings were
# <= 0.040 x scale and the planted faults >= 0.226 x scale; 0.1 lies between.
LOGIT_RTOL = {"float32": 1e-3, "bfloat16": 0.1}
# An MoE model's bf16 logits, routing pinned (``_logit_parity``): at
# olmoe-1b-7b's width the sound readings were 0.011-0.013 x scale and one
# dropped prefix key read 0.059 x scale (NVIDIA H100 80GB HBM3, 700.00 W),
# inside 0.1; 0.03 lies between.
LOGIT_RTOL_MOE_BF16 = 0.03
REPLACES = {
    "paged_decode": "src/repro/kernels/paged_decode.py:208",
    "flash_prefill": "src/repro/kernels/flash_prefill.py:106",
    "suffix_prefill": "src/repro/kernels/flash_suffix_prefill.py:152",
    "paged_decode_int8": "src/repro/kernels/paged_decode.py:208",
    "suffix_prefill_int8": "src/repro/kernels/flash_suffix_prefill.py:152",
    "int8_encode": "src/repro/kernels/quantize.py:74",
    "kv_write_int8": "src/repro/kernels/quantize.py:74",
    "int8_roundtrip": "src/repro/kernels/quantize.py:96",
    "topk_sparsify": "src/repro/kernels/topk_compress.py:50",
    "sq_norm": "src/repro/kernels/dp_clip.py:36",
    "clip_noise": "src/repro/kernels/dp_clip.py:58",
    "paged_decode_ring": "src/repro/kernels/paged_decode.py:144",
    "swa_decode": "src/repro/kernels/swa_decode.py:85",
}
SOURCES = {
    "paged_decode": "src/repro_torch/csrc/paged_decode.cu",
    "flash_prefill": "src/repro_torch/csrc/flash_prefill.cu",
    "suffix_prefill": "src/repro_torch/csrc/flash_suffix_prefill.cu",
    "paged_decode_int8": "src/repro_torch/csrc/paged_decode.cu",
    "suffix_prefill_int8": "src/repro_torch/csrc/flash_suffix_prefill.cu",
    "int8_encode": "src/repro_torch/csrc/quantize.cu",
    "kv_write_int8": "src/repro_torch/csrc/quantize.cu",
    "int8_roundtrip": "src/repro_torch/csrc/quantize.cu",
    "topk_sparsify": "src/repro_torch/csrc/topk_compress.cu",
    "sq_norm": "src/repro_torch/csrc/dp_clip.cu",
    "clip_noise": "src/repro_torch/csrc/dp_clip.cu",
    "paged_decode_ring": "src/repro_torch/csrc/paged_decode.cu",
    "swa_decode": "src/repro_torch/csrc/swa_decode.cu",
}
SERVING = ("paged_decode", "flash_prefill", "suffix_prefill")
# the int8 serving path: cold prefill attends fp k/v (flash_prefill), every
# pool write is one kv_write_int8 launch per layer, decode and suffix read
# int8 pages
SERVING_INT8 = ("flash_prefill", "paged_decode_int8", "suffix_prefill_int8", "kv_write_int8")
CHANNEL = ("int8_roundtrip", "topk_sparsify", "sq_norm", "clip_noise")
FP32_FLOPS = 67e12             # H100 SXM fp32 peak outside the tensor cores
# The DP norm, kernel vs plain: both sum in fp32 in other orders (the
# kernel's fixed chunks and butterflies vs PyTorch's reduction); over 2e8
# squares the relative error of either is ~1e-7. A dropped chunk
# (``dp_clip.CHUNK`` elements) or ragged tail moves it by far more than 1e-6.
SQ_NORM_RTOL = 1e-6
# The training path's settings.
TOPK_RATIO, DP_CLIP, DP_NOISE, NOISE_SEED = 0.01, 1.0, 0.1, 1234
TRAIN = dict(arch="stablelm-1.6b", smoke=False, steps=4, seq_len=256, per_cloud_batch=8,
             n_clouds=2, local_steps=2, aggregation="fedavg", compression="topk+int8",
             topk_ratio=TOPK_RATIO, dp_clip=DP_CLIP, dp_noise=DP_NOISE)
# Sync round, kernels vs plain versions: they differ only in the norm's
# summation order, so the clip scale may differ in its last ulp; that moves
# a transmitted delta by ~1e-7 of itself, and a new bf16 parameter only
# where g + aggregate sat at a rounding boundary: ~1 element in 1e9. A
# sound run may differ in at most 1e-6 of the parameters, each by at most
# one bf16 ulp (2**-7 relative); a planted fault (top-k keeping k - 1 per
# block) changes ~1e-3 of them.
SYNC_DIFF_FRAC = 1e-6


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


FAILED: list[str] = []


def expect(cond: bool, what: str) -> None:
    """A numeric check whose failure is reported at once and fails the run
    at its end, so that every reading of the run is still printed."""
    if not cond:
        log(f"FAILED: {what}")
        FAILED.append(what)


# The last sound window of ``timed_ms``: per kernel name, (launches per
# call, device ms per call).
LAST_KERNELS: dict[str, tuple[float, float]] = {}
# Profiler windows per timed call at most: on an H100 two windows in a row
# now and then held no kernel record at all (phases 3b and 6).
TIMING_ATTEMPTS = 5


def timed_ms(fn, iters: int = 20, bound_ms: float = 0.0) -> tuple[float, float]:
    """(device ms, wall ms) per call of ``fn``. Device time is the sum of
    the profiler's kernel rows (every kernel the call launched) over a
    window of ``iters`` calls that follows a warm-up window of as many
    (the profiler drops its records); wall time is CUDA events around
    ``iters`` back-to-back calls, host work included. ``bound_ms``, if
    given, is the least time the card could take for a call: a window that
    reads less lost records. If every window lost records, each kernel is
    timed per record it kept, times its launches per call. The window's
    rows by kernel are left in ``LAST_KERNELS``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    wall = start.elapsed_time(end) / iters
    cuda = torch.autograd.DeviceType.CUDA
    lost = True
    kept = None  # the last window that held kernel records
    for attempt in range(TIMING_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        # (the step's own annotation has a device row spanning its kernels)
        rows = [e for e in prof.key_averages()
                if e.device_type == cuda and not e.key.startswith("ProfilerStep")]
        dev = sum(e.self_device_time_total for e in rows)
        # A sound window holds every kernel of the iters calls once: each
        # kernel's record count a multiple of iters, no less device time
        # than the bound and no more than the back-to-back wall. Without the
        # warm-up window, the first records of windows over calls of a
        # millisecond went missing (up to half of them) on an H100; with it,
        # now and then a few, and now and then all of them (windows of
        # cuDNN's SDPA kernels): such a window is taken again, and a call
        # whose every window is empty fails below. Some calls lost records
        # in every window (the plain sigma = 0 clip kept 3 or 4 of 5, or 1
        # in a window between two empty ones): an empty last window falls
        # back to the last window with records.
        if dev == 0:
            log(f"[timing] the profiler saw no kernel (attempt {attempt + 1} of "
                f"{TIMING_ATTEMPTS})")
            if kept is not None:
                rows, dev, counts = kept
            continue
        counts = {e.key: e.count for e in rows}
        kept = (rows, dev, counts)
        per_call = dev / iters / 1e3
        lost = any(n % iters for n in counts.values()) or per_call < bound_ms
        if not lost and per_call <= 1.02 * wall:
            break
        evs = prof.events()
        kern = [e.time_range for e in evs
                if e.device_type == cuda and not e.name.startswith("ProfilerStep")]
        host = [e.time_range for e in evs if e.device_type != cuda]
        t0 = min(t.start for t in host)
        log(f"[timing] suspect profiler window (attempt {attempt + 1} of {TIMING_ATTEMPTS}): "
            f"device {per_call:.4f} ms vs wall {wall:.4f} ms and bound {bound_ms:.4f} ms per call "
            f"over {iters} calls; "
            f"kernel records {counts}; kernel span {min(t.start for t in kern) - t0:.1f}.."
            f"{max(t.end for t in kern) - t0:.1f} us, host span 0.."
            f"{max(t.end for t in host) - t0:.1f} us")
    check(dev > 0, "the profiler saw no kernel: device time not measured")
    if lost:
        log(f"[timing] every window lost records: {sum(counts.values())} kept; each kernel "
            "timed per record, times its launches per call")
    LAST_KERNELS.clear()
    for e in rows:
        calls = max(1, round(e.count / iters)) if lost else e.count / iters
        LAST_KERNELS[e.key] = (calls, e.self_device_time_total / e.count * calls / 1e3)
    return sum(t for _, t in LAST_KERNELS.values()), wall


# The plain versions behind the ops entry points, fp or int8 pools by
# whether scales are given (``scale``: the softmax scale, as the ops pass it).
def _plain_decode(q, kp, vp, pos, table, window=0, k_scale=None, v_scale=None, scale=None):
    from repro_torch.kernels import ref

    if k_scale is None:
        return ref.paged_decode_ref(q, kp, vp, pos, table, window, scale)
    return ref.paged_decode_int8_ref(q, kp, vp, k_scale, v_scale, pos, table, window, scale)


def _plain_suffix(q, ks, vs, pk, pv, table, starts, *, prefix_width, pool_k_scale=None,
                  pool_v_scale=None, scale=None):
    from repro_torch.kernels import ref

    if pool_k_scale is None:
        return ref.suffix_prefill_ref(q, ks, vs, pk, pv, table, starts,
                                      prefix_width=prefix_width, scale=scale)
    return ref.suffix_prefill_int8_ref(q, ks, vs, pk, pv, pool_k_scale, pool_v_scale, table,
                                       starts, prefix_width=prefix_width, scale=scale)


# Planted faults: the plain versions with one deliberate error each, which
# the kernel-vs-plain comparisons must tell from the sound plain versions.
def _decode_shift(q, kp, vp, pos, table, window=0, **scales):
    """Mask shifted by one: the newest key (at ``pos``) is left out."""
    return _plain_decode(q, kp, vp, pos - 1, table, window, **scales)


def _decode_drop_page(q, kp, vp, pos, table, window=0, **scales):
    """The row's last live page (the one holding ``pos``) is left out."""
    page = kp.shape[1]
    return _plain_decode(q, kp, vp, pos // page * page - 1, table, window, **scales)


def _decode_scale_slot(q, kp, vp, pos, table, window=0, k_scale=None, v_scale=None,
                       scale=None):
    """int8: every key's scale read from the next token slot of its page."""
    return _plain_decode(q, kp, vp, pos, table, window, k_scale.roll(1, dims=1),
                         v_scale.roll(1, dims=1), scale)


def _decode_scale_head(q, kp, vp, pos, table, window=0, k_scale=None, v_scale=None,
                       scale=None):
    """int8: every key's scale read from the next kv head."""
    return _plain_decode(q, kp, vp, pos, table, window, k_scale.roll(1, dims=2),
                         v_scale.roll(1, dims=2), scale)


def _decode_no_round(q, kp, vp, pos, table, window=0, k_scale=None, v_scale=None,
                     scale=None):
    """int8: the pool dequantized in f32 and not rounded to q's dtype."""
    from repro_torch.kernels import ref

    out = ref.paged_decode_ref(q.float(), ref.dequant_pool_ref(kp, k_scale),
                               ref.dequant_pool_ref(vp, v_scale), pos, table, window, scale)
    return out.to(q.dtype)


def _prefill_shift(q, k, v, *, window=0, scale=None):
    """Causal mask shifted by one: query i sees keys 0..i-1 (query 0 keeps
    key 0)."""
    import torch

    from repro_torch.kernels import ref

    head = ref.flash_prefill_ref(q[:, :1], k[:, :1], v[:, :1], window=window, scale=scale)
    rest = ref.flash_prefill_ref(q[:, 1:], k[:, :-1], v[:, :-1], window=window, scale=scale)
    return torch.cat([head, rest], 1)


def _prefill_no_window(q, k, v, *, window=0, scale=None):
    """The sliding window dropped: every query sees every earlier key."""
    from repro_torch.kernels import ref

    return ref.flash_prefill_ref(q, k, v, window=0, scale=scale)


def _suffix_shift(q, ks, vs, pk, pv, table, starts, *, prefix_width, **scales):
    """The last cached prefix key is left out."""
    return _plain_suffix(q, ks, vs, pk, pv, table, (starts - 1).clamp(min=0),
                         prefix_width=prefix_width, **scales)


def _suffix_drop_page(q, ks, vs, pk, pv, table, starts, *, prefix_width, **scales):
    """The last cached prefix page is left out."""
    page = pk.shape[1]
    cut = (starts - (starts - 1) % page - 1).clamp(min=0)
    return _plain_suffix(q, ks, vs, pk, pv, table, cut, prefix_width=prefix_width, **scales)


def _suffix_scale_slot(q, ks, vs, pk, pv, table, starts, *, prefix_width, pool_k_scale,
                       pool_v_scale, scale=None):
    """int8: every prefix key's scale read from the next token slot."""
    return _plain_suffix(q, ks, vs, pk, pv, table, starts, prefix_width=prefix_width,
                         pool_k_scale=pool_k_scale.roll(1, dims=1),
                         pool_v_scale=pool_v_scale.roll(1, dims=1), scale=scale)


def _suffix_scale_head(q, ks, vs, pk, pv, table, starts, *, prefix_width, pool_k_scale,
                       pool_v_scale, scale=None):
    """int8: every prefix key's scale read from the next kv head."""
    return _plain_suffix(q, ks, vs, pk, pv, table, starts, prefix_width=prefix_width,
                         pool_k_scale=pool_k_scale.roll(1, dims=2),
                         pool_v_scale=pool_v_scale.roll(1, dims=2), scale=scale)


def _suffix_no_round(q, ks, vs, pk, pv, table, starts, *, prefix_width, pool_k_scale,
                     pool_v_scale, scale=None):
    """int8: the prefix pool dequantized in f32 and not rounded to q's
    dtype."""
    from repro_torch.kernels import ref

    out = ref.suffix_prefill_ref(q.float(), ks.float(), vs.float(),
                                 ref.dequant_pool_ref(pk, pool_k_scale),
                                 ref.dequant_pool_ref(pv, pool_v_scale), table, starts,
                                 prefix_width=prefix_width, scale=scale)
    return out.to(q.dtype)


# The int8 pool write's planted faults (phase 3b).
def _write_slot_shift(pool, k, v, table, starts, lengths=None):
    """Every token written one ring slot on."""
    from repro_torch.kernels import ref

    ref.kv_write_int8_ref(pool, k, v, table, starts + 1, lengths)


def _write_scale_128(pool, k, v, table, starts, lengths=None):
    """Every scale max|x| / 128 instead of / 127."""
    import torch

    from repro_torch.kernels import ref

    def quant(x):
        xf = x.float()
        amax = xf.abs().amax(dim=-1)
        scale = (amax / amax.new_tensor(128.0)).clamp(min=1e-12)
        return torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8), scale

    saved, ref.kv_quant_ref = ref.kv_quant_ref, quant
    try:
        ref.kv_write_int8_ref(pool, k, v, table, starts, lengths)
    finally:
        ref.kv_quant_ref = saved


def _live_writes(starts, lengths, cap, page):
    """(live tokens, distinct (row, table entry) pairs they land on) of a
    pool write; ``lengths`` None: one token per row."""
    live, pages = 0, set()
    for r, start in enumerate(starts):
        n = 1 if lengths is None else lengths[r]
        for j in range(max(0, n - cap), n):
            live += 1
            pages.add((r, (start + j) % cap // page))
    return live, len(pages)


@contextlib.contextmanager
def plain_kernels(**swap):
    """Route the model's attention (fp or int8 pools) and the int8 pool
    writes through the plain versions, on whatever device the tensors are:
    the reference run of the logit comparison. ``swap`` replaces some of
    them (``paged_decode=``, ``flash_prefill=``, ``suffix_prefill=``,
    ``kv_write=``, ``ring_decode=``), e.g. with a planted fault."""
    from repro_torch.kernels import ops, ref

    names = {"paged_decode": "paged_decode_attention",
             "flash_prefill": "flash_prefill_attention",
             "suffix_prefill": "suffix_prefill_attention",
             "kv_write": "kv_write_int8", "ring_decode": "swa_decode_attention"}
    plain = {"paged_decode": _plain_decode, "flash_prefill": ref.flash_prefill_ref,
             "suffix_prefill": _plain_suffix, "kv_write": ref.kv_write_int8_ref,
             "ring_decode": _plain_ring, **swap}
    saved = {k: getattr(ops, attr) for k, attr in names.items()}
    for k, attr in names.items():
        setattr(ops, attr, plain[k])
    try:
        yield
    finally:
        for k, attr in names.items():
            setattr(ops, attr, saved[k])


@contextlib.contextmanager
def plain_channel(**swap):
    """Route the channel kernels' wrappers to their plain versions on
    whatever device the tensors are; ``swap`` replaces some of them
    (``topk_sparsify=``, ``int8_roundtrip=``, ``sq_norm=``, ``clip_noise=``),
    e.g. with a planted fault."""
    from repro_torch.kernels import dp_clip, quantize, ref, topk_compress

    where = {"topk_sparsify": topk_compress, "int8_roundtrip": quantize,
             "sq_norm": dp_clip, "clip_noise": dp_clip}
    plain = {"topk_sparsify": ref.topk_sparsify_ref, "int8_roundtrip": ref.int8_roundtrip_ref,
             "sq_norm": ref.sq_norm_ref, "clip_noise": ref.clip_noise_ref, **swap}
    saved = {k: getattr(mod, k) for k, mod in where.items()}
    for k, mod in where.items():
        setattr(mod, k, plain[k])
    try:
        yield
    finally:
        for k, mod in where.items():
            setattr(mod, k, saved[k])


# ------------------------------------------------------------------ phase 1
def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA GPU")
    import repro_torch  # noqa: F401  (fails before any output outside a checkout)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        "matmul.allow_bf16_reduced_precision_reduction="
        f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
    return smi


# ------------------------------------------------------------------ phase 2
# The bf16 prefill kernels run on the tensor cores through TMA: their
# libraries must hold wgmma (HGMMA) and TMA-load (UTMALDG) instructions.
TC_SOURCES = ("flash_prefill", "flash_suffix_prefill")
TC_OPCODES = ("HGMMA", "UTMALDG")
# the channel's block kernels: one warp per block, warp reductions (REDUX),
# no block barrier (BAR)
BLOCK_SOURCES = ("topk_compress", "quantize")


def _ptxas_by_kernel(report: str) -> list[str]:
    """'kernel: registers, shared memory[, spills]' per entry function of an
    ``-Xptxas -v`` report, the names demangled where ``c++filt`` exists."""
    rows, name = [], None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            rows.append([name])
        elif name is not None and ("Used" in line or "spill" in line):
            rows[-1].append(line.split("ptxas info    : ")[-1].strip())
    try:
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True, check=True).stdout.split("\n")
    except (OSError, subprocess.CalledProcessError):
        names = [r[0] for r in rows]
    return [f"{n}: {'; '.join(r[1:])}" for n, r in zip(names, rows)]


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    reports = build.build_all()
    log(f"[build] {len(reports)} kernel libraries built in {time.perf_counter() - t0:.1f} s")
    for name, out in reports.items():
        if name in TC_SOURCES + BLOCK_SOURCES:
            for row in _ptxas_by_kernel(out):
                log(f"[build] {name}: {row}")
            continue
        regs = sorted({line.split("ptxas info    : ")[-1] for line in out.splitlines()
                       if "registers" in line})
        spills = [int(line.split(" bytes spill stores")[0].split()[-1])
                  for line in out.splitlines() if " bytes spill stores" in line]
        log(f"[build] {name}: {'; '.join(regs)}; largest spill stores of its "
            f"{len(spills)} kernels: {max(spills, default=0)} bytes")
        if name in ("paged_decode", "swa_decode"):   # the hd-256 ring instantiations
            for row in _ptxas_by_kernel(out):
                if ", 256," in row.split(": ")[0] or ", 256>" in row.split(": ")[0]:
                    log(f"[build] {name}: {row}")
    for name in TC_SOURCES:
        ops = build.sass_opcodes(name)
        has = {op: op in ops for op in TC_OPCODES}
        log(f"[build] {name} SASS: HGMMA (tensor-core wgmma) {has['HGMMA']}, UTMALDG (TMA "
            f"load) {has['UTMALDG']}")
        check(all(has.values()), f"{name}: SASS lacks {[op for op, h in has.items() if not h]}")
    for name in BLOCK_SOURCES:
        ops = build.sass_opcodes(name)
        log(f"[build] {name} SASS: REDUX (warp reduction) {'REDUX' in ops}, BAR (block "
            f"barrier) {'BAR' in ops}")
        check("REDUX" in ops and "BAR" not in ops, f"{name}: SASS has BAR or lacks REDUX")


# ------------------------------------------------------------------ phase 3
def _table(gen, live_pages, width, num_pages, shared=0):
    """Scattered page table: row r's first live_pages[r] logical pages at
    random distinct physical pages (the first ``shared`` of them common to
    all rows), the rest scratch page 0."""
    import torch

    perm = torch.randperm(num_pages - 1, generator=gen) + 1
    need = shared + sum(max(n - shared, 0) for n in live_pages)
    check(need <= num_pages - 1, f"pool of {num_pages} pages cannot hold {need}")
    table = torch.zeros(len(live_pages), width, dtype=torch.int32)
    nxt = shared
    for r, n in enumerate(live_pages):
        own = n - min(n, shared)
        table[r, :n] = torch.cat([perm[: min(n, shared)], perm[nxt: nxt + own]])
        nxt += own
    return table


def _decode_case(gen, dt, b, hkv, g, hd, page, t_w, num_pages, pos_list, shared):
    import torch

    d = DEVICE
    q = torch.randn(b, hkv, g, hd, generator=gen).to(d, dt)
    kp = torch.randn(num_pages, page, hkv, hd, generator=gen).to(d, dt)
    vp = torch.randn(num_pages, page, hkv, hd, generator=gen).to(d, dt)
    pos = torch.tensor(pos_list, dtype=torch.int32)
    live = [min(-(-(p + 1) // page), t_w) for p in pos_list]
    table = _table(gen, live, t_w, num_pages, shared).to(d)
    return q, kp, vp, pos.to(d), table


def _unique_tokens(table, spans, page):
    """Distinct (physical page, offset) slots that rows read: row r reads
    its logical token slots 0..spans[r]-1 through its table row."""
    tab = table.cpu().tolist()
    return len({(tab[r][c // page], c % page) for r, n in enumerate(spans) for c in range(n)})


def _split_plan(cap, q_shape, limits):
    """The split-KV decode kernels' launch at this shape, by the split rule
    of ``kernels/paged_decode.py`` (``launch_plan``): keys per range, ranges
    per row, blocks launched, and the blocks whose range holds a slot the
    kernel reads (``limits``: per row, the live span in whole pages, or the
    ring for ``swa_decode``); the others write the identity partial."""
    from repro_torch.kernels.paged_decode import launch_plan

    plan = launch_plan(cap, tuple(q_shape))
    per_range = plan["blocks"] // (plan["ranges"] * q_shape[0])
    live = sum(-(-lim // plan["split"]) for lim in limits) * per_range
    return (f"split {plan['split']} slots, {plan['ranges']} ranges per row, {plan['blocks']} "
            f"blocks launched, {live} with a live range")


def _rows_alone(call, b):
    """Whether ``call(rows)`` over the whole batch equals, row by row and
    bitwise, ``call`` over each row alone (``rows``: a slice of the batch)."""
    import torch

    whole = call(slice(0, b))
    return all(torch.equal(whole[r:r + 1], call(slice(r, r + 1))) for r in range(b))


def phase_kernels(smi):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    gen = torch.Generator().manual_seed(1)
    rows = {}

    def compare(name, dt, shape, out, plain, faults=()):
        """Kernel output vs plain version (relative to the plain output's
        RMS), and each planted fault's output vs the kernel's."""
        dname = str(dt).split(".")[-1]
        tol = RTOL[dname]
        rms = plain.float().pow(2).mean().sqrt().item()
        e = (out.float() - plain.float()).abs().max().item()
        msg = (f"[kernels] {name} {dname} {shape}: max_abs_err {e:.3e}, plain RMS {rms:.3e}, "
               f"err/RMS {e / rms:.3e} (tol {tol:g})")
        expect(e <= tol * rms, f"{name} {dname} {shape}: err/RMS {e / rms} > {tol}")
        for fname, fout in faults:
            fe = (out.float() - fout.float()).abs().max().item()
            msg += f"; planted fault '{fname}' err/RMS {fe / rms:.3e}"
            expect(fe > tol * rms, f"{name} {dname}: planted fault '{fname}' within tolerance")
        log(msg)
        return e

    # --- paged decode at the main path's shape: 8 slots at depths 100..380,
    # the first 6 pages shared (a common prompt prefix), scratch tails
    b, hkv, hd, page, t_w, num_pages = 8, 32, 64, 16, 208, 209
    elem = 2
    pos_list = [100 + 40 * r for r in range(b)]
    q, kp, vp, pos, table = _decode_case(gen, torch.bfloat16, b, hkv, 1, hd, page, t_w,
                                         num_pages, pos_list, shared=6)
    dec = (q, kp, vp, pos, table)
    e = compare("paged_decode", torch.bfloat16, "B8 Hkv32 G1 hd64 page16",
                ops.paged_decode_attention(*dec), ref.paged_decode_ref(*dec),
                [("mask shifted by one", _decode_shift(*dec)),
                 ("last live page dropped", _decode_drop_page(*dec))])
    # library call: each row's live pages only, padded to the longest span
    live = [-(-(p + 1) // page) for p in pos_list]
    kg = ref.gather_pages_ref(kp, table[:, : max(live)]).transpose(1, 2)   # (B, H, C, hd)
    vg = ref.gather_pages_ref(vp, table[:, : max(live)]).transpose(1, 2)
    mask = torch.arange(max(live) * page, device=DEVICE)[None, :] <= pos[:, None].long()
    qs = q.reshape(b, hkv, 1, hd)
    spans = [p + 1 for p in pos_list]
    uniq = _unique_tokens(table, spans, page)
    ms, wall = timed_ms(lambda: ops.paged_decode_attention(*dec))
    rows["paged_decode"] = dict(
        max_abs_err=e, ms=ms, wrapper_ms=wall,
        plain_ms=timed_ms(lambda: ref.paged_decode_ref(*dec))[0],
        library_ms=timed_ms(lambda: F.scaled_dot_product_attention(
            qs, kg, vg, attn_mask=mask[:, None, None, :]))[0],
        # q and out, each distinct live K/V slot once, pos and live table entries
        bytes=(2 * b * hkv * hd + 2 * uniq * hkv * hd) * elem + 4 * (b + sum(live)),
        flops=4 * sum(spans) * hkv * hd,
    )
    log(f"[kernels] paged_decode bound counts {uniq} distinct live tokens "
        f"({sum(spans)} over the rows)")
    alone = _rows_alone(lambda r: ops.paged_decode_attention(
        q[r].contiguous(), kp, vp, pos[r].contiguous(), table[r].contiguous()), b)
    expect(alone, "paged_decode B8 page16: a row's output alone differs from its output in "
                  "the batch")
    log(f"[kernels] paged_decode B{b} page{page} T{t_w}: "
        f"{_split_plan(t_w * page, q.shape, [n * page for n in live])}; each row alone "
        f"bitwise equal to its output in the batch: {alone}")

    # --- flash prefill at the cold round's shape: 8 rows, bucket 512
    n, s = 8, 512
    q5 = torch.randn(n, s, hkv, 1, hd, generator=gen).to(DEVICE, torch.bfloat16)
    k4 = torch.randn(n, s, hkv, hd, generator=gen).to(DEVICE, torch.bfloat16)
    v4 = torch.randn(n, s, hkv, hd, generator=gen).to(DEVICE, torch.bfloat16)
    e = compare("flash_prefill", torch.bfloat16, "B8 S512 Hkv32 G1 hd64",
                ops.flash_prefill_attention(q5, k4, v4), ref.flash_prefill_ref(q5, k4, v4),
                [("mask shifted by one", _prefill_shift(q5, k4, v4))])
    qt, kt, vt = (x.reshape(n, s, hkv, hd).transpose(1, 2) for x in (q5, k4, v4))
    ms, wall = timed_ms(lambda: ops.flash_prefill_attention(q5, k4, v4))
    rows["flash_prefill"] = dict(
        max_abs_err=e, ms=ms, wrapper_ms=wall,
        plain_ms=timed_ms(lambda: ref.flash_prefill_ref(q5, k4, v4), iters=5)[0],
        library_ms=timed_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                   is_causal=True))[0],
        bytes=4 * n * s * hkv * hd * elem,
        flops=4 * n * hkv * hd * s * (s + 1) // 2,
    )
    del q5, k4, v4, qt, kt, vt
    _ring_prefill_row(smi, gen, rows["flash_prefill"])

    # --- suffix prefill at the hit round's shape: 8 rows of 64-token
    # suffixes behind a 256-token prefix shared by all (16 pages, W 16)
    s_suf, start, w_pfx = 64, 256, 16
    q5 = torch.randn(n, s_suf, hkv, 1, hd, generator=gen).to(DEVICE, torch.bfloat16)
    ks = torch.randn(n, s_suf, hkv, hd, generator=gen).to(DEVICE, torch.bfloat16)
    vs = torch.randn(n, s_suf, hkv, hd, generator=gen).to(DEVICE, torch.bfloat16)
    live = [(start + s_suf) // page] * n
    stable = _table(gen, live, t_w, num_pages, shared=w_pfx).to(DEVICE)
    starts = torch.full((n,), start, dtype=torch.int32, device=DEVICE)
    args = (q5, ks, vs, kp, vp, stable, starts)
    e = compare("suffix_prefill", torch.bfloat16, "n8 S64 start256 W16 Hkv32 G1 hd64",
                ops.suffix_prefill_attention(*args, prefix_width=w_pfx),
                ref.suffix_prefill_ref(*args, prefix_width=w_pfx),
                [("last prefix key dropped", _suffix_shift(*args, prefix_width=w_pfx)),
                 ("last prefix page dropped", _suffix_drop_page(*args, prefix_width=w_pfx))])
    kc = torch.cat([ref.gather_pages_ref(kp, stable[:, :w_pfx]), ks], 1).transpose(1, 2)
    vc = torch.cat([ref.gather_pages_ref(vp, stable[:, :w_pfx]), vs], 1).transpose(1, 2)
    kpos = torch.arange(start + s_suf, device=DEVICE)
    smask = (kpos[None, :] <= start + torch.arange(s_suf, device=DEVICE)[:, None])
    qt = q5.reshape(n, s_suf, hkv, hd).transpose(1, 2)
    uniq = _unique_tokens(stable, [min(start, w_pfx * page)] * n, page)
    pp = min(-(-start // page), w_pfx)
    ms, wall = timed_ms(lambda: ops.suffix_prefill_attention(*args, prefix_width=w_pfx))
    rows["suffix_prefill"] = dict(
        max_abs_err=e, ms=ms, wrapper_ms=wall,
        plain_ms=timed_ms(lambda: ref.suffix_prefill_ref(*args, prefix_width=w_pfx))[0],
        library_ms=timed_ms(lambda: F.scaled_dot_product_attention(qt, kc, vc,
                                                                   attn_mask=smask))[0],
        # q, suffix k/v and out per row, each distinct prefix slot once,
        # starts and the prefix table entries
        bytes=(4 * n * s_suf + 2 * uniq) * hkv * hd * elem + 4 * n * (1 + pp),
        flops=4 * n * hkv * hd * (s_suf * start + s_suf * (s_suf + 1) // 2),
    )
    log(f"[kernels] suffix_prefill bound counts {uniq} distinct prefix tokens "
        f"({n * start} over the rows)")

    # --- GQA (G 4, hd 128) in bf16, and every kernel in float32
    for dt, (b2, hkv2, g2, hd2) in ((torch.bfloat16, (4, 8, 4, 128)),
                                   (torch.float32, (3, 4, 2, 64))):
        pos_list = [5, 77, 130, 200][:b2]
        q, kp2, vp2, pos2, table2 = _decode_case(gen, dt, b2, hkv2, g2, hd2, 16, 16, 64,
                                                 pos_list, shared=2)
        compare("paged_decode", dt, f"B{b2} Hkv{hkv2} G{g2} hd{hd2} window40",
                ops.paged_decode_attention(q, kp2, vp2, pos2, table2, 40),
                ref.paged_decode_ref(q, kp2, vp2, pos2, table2, 40))
        s2 = 100
        q5 = torch.randn(b2, s2, hkv2, g2, hd2, generator=gen).to(DEVICE, dt)
        k4 = torch.randn(b2, s2, hkv2, hd2, generator=gen).to(DEVICE, dt)
        v4 = torch.randn(b2, s2, hkv2, hd2, generator=gen).to(DEVICE, dt)
        compare("flash_prefill", dt, f"B{b2} S{s2} Hkv{hkv2} G{g2} hd{hd2}",
                ops.flash_prefill_attention(q5, k4, v4), ref.flash_prefill_ref(q5, k4, v4))
        st2 = torch.tensor([0, 17, 48, 64][:b2], dtype=torch.int32, device=DEVICE)
        sargs = (q5, k4, v4, kp2, vp2, table2, st2)
        compare("suffix_prefill", dt, f"n{b2} S{s2} starts0..64 Hkv{hkv2} G{g2} hd{hd2}",
                ops.suffix_prefill_attention(*sargs, prefix_width=4),
                ref.suffix_prefill_ref(*sargs, prefix_width=4))

    for name, r in rows.items():
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["flops"] / BF16_FLOPS * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        log(f"[kernels] {name} path shape ({smi}): kernel device ms {r['ms']:.4f} (wrapper "
            f"wall {r['wrapper_ms']:.4f}) plain_ms {r['plain_ms']:.4f} library_ms "
            f"{r['library_ms']:.4f} bound_ms {r['bound_ms']:.4f} ({r['bound_by']}: "
            f"{r['bytes'] / 1e6:.2f} MB, {r['flops'] / 1e9:.3f} GFLOP)")
    return rows


# The ring path's first cold round: 4 rows padded to an 8192-token bucket,
# window 4096 (stablelm-1.6b: Hkv 32, G 1, hd 64, bf16). The plain version's
# fp32 scores at that shape would take 34 GB, so the kernel's output is held
# against it slice by slice: one row and RING_HEADS kv heads at a time (2.1 GB
# of scores each; every block of the kernel is one (row, kv head) pair).
RING_COLD = dict(b=4, s=8192, hkv=32, hd=64, window=4096)
RING_HEADS = 8


def _ring_prefill_row(smi, gen, path_row):
    """``flash_prefill`` at the ring path's cold round: device times at the
    full shape against SDPA with the windowed causal mask (the bound counts
    the live (query, key) pairs only), then the timed output against the
    plain version over every (row, block of kv heads) slice.

    Gate: err/RMS <= RTOL per slice, where err leaves out one-ulp flips:
    elements where the kernel's and the plain version's bf16 outputs are
    adjacent bf16 numbers (the last bit of two roundings of nearly equal
    fp32 values). At this shape the early positions' outputs (few keys,
    values of 0.5-4) are 10-80x the slice's RMS (~0.05), so one flip there
    is 0.08-0.3 x RMS while the plain version's own bf16 output is as far
    from its fp32 value (both logged): the plain err/RMS would fail any
    kernel that does not reproduce the plain version bit for bit. The raw
    err (flips included) joins the path row's ``max_abs_err``; the
    shifted-mask fault is held outside the tolerance on the first slice."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    c = RING_COLD
    b, s, hkv, hd, w = c["b"], c["s"], c["hkv"], c["hd"], c["window"]
    tol = RTOL["bfloat16"]
    q5 = torch.randn(b, s, hkv, 1, hd, generator=gen).to(DEVICE, torch.bfloat16)
    k4 = torch.randn(b, s, hkv, hd, generator=gen).to(DEVICE, torch.bfloat16)
    v4 = torch.randn(b, s, hkv, hd, generator=gen).to(DEVICE, torch.bfloat16)
    qt, kt, vt = (x.reshape(b, s, hkv, hd).transpose(1, 2) for x in (q5, k4, v4))
    pos = torch.arange(s, device=DEVICE)
    wmask = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < w)
    ms, wall = timed_ms(lambda: ops.flash_prefill_attention(q5, k4, v4, window=w), iters=5)
    lib = timed_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=wmask),
                   iters=5)[0]
    del qt, kt, vt, wmask
    out = ops.flash_prefill_attention(q5, k4, v4, window=w)
    raw = gated = own = 0.0
    flips = 0
    for r in range(b):
        for h in range(0, hkv, RING_HEADS):
            sl = (slice(r, r + 1), slice(None), slice(h, h + RING_HEADS))
            exact = ref.flash_prefill_ref(q5[sl].float(), k4[sl].float(), v4[sl].float(),
                                          window=w)
            plain = exact.to(torch.bfloat16)   # the plain version on the bf16 inputs
            rms = plain.float().pow(2).mean().sqrt().item()
            diff = (out[sl].float() - plain.float()).abs()
            ulps = (out[sl].view(torch.int16).int() - plain.view(torch.int16).int()).abs()
            beyond = diff[ulps > 1]
            e_gated = beyond.max().item() / rms if beyond.numel() else 0.0
            where = f"row {r} kv heads {h}-{h + RING_HEADS - 1}"
            expect(e_gated <= tol, f"flash_prefill bfloat16 ring cold round {where}: err/RMS "
                                   f"beyond one-ulp flips {e_gated} > {tol}")
            if r == h == 0:
                fault = _prefill_shift(q5[sl], k4[sl], v4[sl], window=w)
                fe = (out[sl].float() - fault.float()).abs().max().item() / rms
                expect(fe > tol, "flash_prefill bfloat16 ring cold round: planted fault 'mask "
                                 "shifted by one' within tolerance")
                del fault
            path_row["max_abs_err"] = max(path_row["max_abs_err"], diff.max().item())
            raw = max(raw, diff.max().item() / rms)
            gated = max(gated, e_gated)
            own = max(own, (plain.float() - exact).abs().max().item() / rms)
            flips += int(((ulps == 1) & (diff > tol * rms)).sum())
            del exact, plain, diff, ulps, beyond
            torch.cuda.empty_cache()
    log(f"[kernels] flash_prefill bfloat16 ring cold round B{b} S{s} Hkv{hkv} G1 hd{hd} window{w}"
        f", {b * hkv // RING_HEADS} slices of one row and {RING_HEADS} kv heads: largest err/RMS "
        f"beyond one-ulp flips {gated:.3e} (tol {tol:g}); with them {raw:.3e} ({flips} flips "
        f"above tol x RMS); the plain version's own bf16 rounding {own:.3e} x RMS; planted fault "
        f"'mask shifted by one' err/RMS {fe:.3e} (row 0 kv heads 0-{RING_HEADS - 1})")
    pairs = sum(min(i + 1, w) for i in range(s))           # live (query, key) pairs per head
    flops = 4 * b * hkv * hd * pairs
    nbytes = 4 * b * s * hkv * hd * 2
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    log(f"[kernels] flash_prefill ring cold-round shape B{b} S{s} T{s} Hkv{hkv} G1 hd{hd} "
        f"window{w} ({smi}): kernel device ms {ms:.4f} (wrapper wall {wall:.4f}) plain_ms "
        f"null (its fp32 score tensor would take {b * hkv * s * s * 4 / 1e9:.1f} GB) "
        f"library_ms {lib:.4f} (SDPA, windowed causal mask) bound_ms {max(t_bytes, t_ops):.4f} "
        f"({'bytes' if t_bytes >= t_ops else 'operations'}: {nbytes / 1e6:.2f} MB, "
        f"{flops:.4e} FLOP over {pairs} live pairs per head)")
    del q5, k4, v4, out
    torch.cuda.empty_cache()


# ----------------------------------------------------------------- phase 3b
def _pool_write_rows(smi, gen):
    """Phase 3b's pool-write cases: ``kv_write_int8`` (one layer of
    stablelm-1.6b's int8 pool: Hkv 32, page 16, 225 pages as in the int8
    trace's ample pool) against its plain version, bitwise on every plane outside
    scratch page 0 (where dead decode rows may collide, in no defined
    order), and two planted faults that must differ (the slot off by one,
    the scale divided by 128); the decode write and the suffix round also
    timed. Returns (rows of the two timed cases by label, each case's max
    difference from the plain version)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.quantize import kv_write_int8
    from repro_torch.launch.engine import bucket_length

    scfg = get_config("stablelm-1.6b")
    hkv, hd, page, num_pages = scfg.n_kv_heads, scfg.resolved_head_dim, 16, 225
    _, hit_reqs = _int8_path_requests(scfg.vocab_size)
    suf_lens = [len(r.prompt) - 256 for r in hit_reqs]
    i32 = dict(dtype=torch.int32, device=DEVICE)
    # (label, dtype, hd, table width, pages per row (shared), starts, lengths,
    # S): lengths None is a decode step's one token per row at pos = starts
    pos = [100 + 40 * r for r in range(8)]
    cases = [
        ("decode write 8x32 bf16", torch.bfloat16, hd, 28, ([p // page + 1 for p in pos], 0),
         pos, None, 1),
        (f"suffix write {sum(suf_lens)}x32 bf16", torch.bfloat16, hd, 28,
         ([-(-(256 + n) // page) for n in suf_lens], 16), [256] * 8, suf_lens,
         bucket_length(max(suf_lens))),
        ("decode write, wrapped rings and 2 dead rows on page 0, f32 hd 32", torch.float32, 32,
         4, ([4] * 6 + [0, 0], 0), [64, 70, 127, 200, 5, 63, 9, 9], None, 1),
        ("wrapped rings (cap 64) and a row of length 0", torch.bfloat16, hd, 4, ([4] * 4, 0),
         [40, 50, 63, 7], [64, 30, 2, 0], 64),
        ("rows longer than their rings (cap 32)", torch.bfloat16, hd, 2, ([2] * 2, 0), [3, 0],
         [64, 45], 64),
    ]

    def planes(pool):
        return {key: t.clone() for key, t in pool.items()}

    def differ(a, b):
        """max |a - b| over the q and scale planes outside page 0 (0: bitwise
        equal there)."""
        return max((a[key][1:].float() - b[key][1:].float()).abs().max().item()
                   for key in ("k", "v", "ks", "vs"))

    write_rows, write_errs = {}, []
    for what, dt, hd_c, t_w, (live_pages, shared), starts_l, lens_l, s_len in cases:
        n = len(starts_l)
        table = _table(gen, live_pages, t_w, num_pages, shared=shared).to(DEVICE)
        starts = torch.tensor(starts_l, **i32)
        lengths = None if lens_l is None else torch.tensor(lens_l, **i32)
        k = torch.randn(n, s_len, hkv, hd_c, generator=gen).to(DEVICE, dt)
        v = torch.randn(n, s_len, hkv, hd_c, generator=gen).to(DEVICE, dt)
        shape = (num_pages, page, hkv, hd_c)
        pool = {"k": torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8),
                "v": torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8),
                "ks": torch.rand(shape[:-1], generator=gen),
                "vs": torch.rand(shape[:-1], generator=gen)}
        pool = {key: t.to(DEVICE) for key, t in pool.items()}
        args = (k, v, table, starts, lengths)
        got, want = planes(pool), planes(pool)
        kv_write_int8(got, *args)
        ref.kv_write_int8_ref(want, *args)
        e = differ(got, want)
        write_errs.append(e)
        expect(e == 0, f"kv_write_int8 {what}: kernel differs from the plain version ({e})")
        msg = (f"[int8] kv_write_int8 {what}: q and scale planes bitwise equal outside page 0 "
               f"{e == 0}")
        for fname, fault in (("slot off by one", _write_slot_shift),
                             ("scale divided by 128", _write_scale_128)):
            bad = planes(pool)
            fault(bad, *args)
            fe = differ(got, bad)
            expect(fe > 0, f"kv_write_int8 {what}: planted fault '{fname}' not caught")
            msg += f"; planted fault '{fname}' differs {fe > 0} ({fe:.3e})"
            del bad
        log(msg)
        if what.startswith(("decode write 8", "suffix write")):
            ms, wall = timed_ms(lambda: kv_write_int8(got, *args))
            n_new = sum(c for c, _ in LAST_KERNELS.values())
            plain = planes(pool)
            live, pages_read = _live_writes(starts_l, lens_l, t_w * page, page)
            write_rows[what] = dict(
                max_abs_err=e, ms=ms, wrapper_ms=wall,
                plain_ms=timed_ms(lambda: ref.kv_write_int8_ref(plain, *args), iters=5)[0],
                library_ms=None,
                # the live tokens' k and v read once, their q and f32 scales
                # written once; starts (and lengths), and one table entry per
                # page the live tokens land on
                bytes=live * hkv * 2 * (hd_c * k.element_size() + hd_c + 4)
                + 4 * n * (1 if lens_l is None else 2) + 4 * pages_read,
                flops=3 * 2 * live * hkv * hd_c,
            )
            log(f"[int8] pool write {what} ({smi}): kv_write_int8 {n_new:.0f} launch, device "
                f"ms {ms:.4f}, wall {wall:.4f} ms")
            del plain
        del got, want, pool, k, v

    return write_rows, write_errs


def phase_kernels_int8(smi):
    """The int8-pool decode and suffix kernels, the int8 pool write and the
    flat int8 encoder against their plain versions, at the serving path's
    shapes, a GQA shape and in float32. The attention kernels must also be
    BITWISE equal to the fp kernels over the dequantized pool. Planted
    faults: a scale read from the wrong token slot; the pool dequantized
    without rounding to q's dtype (where that moves the output beyond the
    tolerance), else every scale read from the wrong kv head; the last live
    page dropped."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    gen = torch.Generator().manual_seed(2)
    rows = {}

    def compare(name, dt, shape, out, plain, fp_kernel, faults):
        dname = str(dt).split(".")[-1]
        tol = RTOL[dname]
        rms = plain.float().pow(2).mean().sqrt().item()
        e = (out.float() - plain.float()).abs().max().item()
        same = torch.equal(out, fp_kernel)
        expect(e <= tol * rms, f"{name} {dname} {shape}: err/RMS {e / rms} > {tol}")
        expect(same, f"{name} {dname} {shape}: not bitwise equal to the fp kernel over the "
                     "dequantized pool")
        msg = (f"[int8] {name} {dname} {shape}: max_abs_err {e:.3e}, err/RMS {e / rms:.3e} "
               f"(tol {tol:g}); bitwise equal to the fp kernel over the dequantized pool: "
               f"{same}")
        for fname, fout, must in faults:
            fe = (out.float() - fout.float()).abs().max().item()
            hit = fe > tol * rms
            msg += f"; planted fault '{fname}' err/RMS {fe / rms:.3e}"
            if must:
                expect(hit, f"{name} {dname}: planted fault '{fname}' within tolerance")
            elif not hit:
                msg += " (within tolerance: the wrong-kv-head fault stands in)"
        log(msg)
        return e

    def faults_of(kind, args, kw):
        """(name, output, must be caught) of each planted fault."""
        plain_nr = (_decode_no_round if kind == "decode" else _suffix_no_round)(*args, **kw)
        sound = (_plain_decode if kind == "decode" else _plain_suffix)(*args, **kw)
        rms = sound.float().pow(2).mean().sqrt().item()
        moved = (plain_nr.float() - sound.float()).abs().max().item()
        out = [("scale from the next slot",
                (_decode_scale_slot if kind == "decode" else _suffix_scale_slot)(*args, **kw),
                True),
               ("dequant not rounded to q's dtype", plain_nr, False)]
        if moved <= RTOL[str(args[0].dtype).split(".")[-1]] * rms:
            out.append(("scale from the next kv head",
                        (_decode_scale_head if kind == "decode" else _suffix_scale_head)(
                            *args, **kw), True))
        out.append(("last live page dropped",
                    (_decode_drop_page if kind == "decode" else _suffix_drop_page)(*args, **kw),
                    True))
        return out

    shapes = [("path", torch.bfloat16, (8, 32, 1, 64), 16, 208, 209,
               [100 + 40 * r for r in range(8)], 6),
              ("gqa", torch.bfloat16, (4, 8, 4, 128), 16, 16, 64, [5, 77, 130, 200], 2),
              ("f32", torch.float32, (3, 4, 2, 64), 16, 16, 64, [5, 77, 130], 2)]
    for label, dt, (b, hkv, g, hd), page, t_w, num_pages, pos_list, shared in shapes:
        q, kp, vp, pos, table = _decode_case(gen, dt, b, hkv, g, hd, page, t_w, num_pages,
                                             pos_list, shared)
        kq, ks = ref.kv_quant_ref(kp)
        vq, vs = ref.kv_quant_ref(vp)
        kd, vd = ref.dequant_pool_ref(kq, ks, dt), ref.dequant_pool_ref(vq, vs, dt)
        del kp, vp
        shape = f"B{b} Hkv{hkv} G{g} hd{hd} page{page}"
        dargs, dkw = (q, kq, vq, pos, table), dict(k_scale=ks, v_scale=vs)
        out = ops.paged_decode_attention(*dargs, **dkw)
        e_dec = compare("paged_decode_int8", dt, shape, out, _plain_decode(*dargs, **dkw),
                        ops.paged_decode_attention(q, kd, vd, pos, table),
                        faults_of("decode", dargs, dkw))
        limits = [min(-(-(p + 1) // page), t_w) * page for p in pos_list]
        msg = (f"[int8] paged_decode_int8 {str(dt).split('.')[-1]} {shape}: "
               f"{_split_plan(t_w * page, q.shape, limits)}")
        if label == "path":
            alone = _rows_alone(lambda r: ops.paged_decode_attention(
                q[r].contiguous(), kq, vq, pos[r].contiguous(), table[r].contiguous(), **dkw), b)
            expect(alone, f"paged_decode_int8 {shape}: a row's output alone differs from its "
                          "output in the batch")
            msg += f"; each row alone bitwise equal to its output in the batch: {alone}"
        log(msg)
        # suffix rows: 64-token suffixes (100 in the GQA and f32 cases)
        # behind the cached prefix of the first live pages
        n, s_suf = b, (64 if label == "path" else 100)
        start = 256 if label == "path" else 48
        w_pfx = -(-start // page)
        live = [w_pfx + 1] * n
        stable = _table(gen, live, t_w, num_pages, shared=w_pfx).to(DEVICE)
        starts = torch.full((n,), start, dtype=torch.int32, device=DEVICE)
        if label != "path":
            starts[0] = 0                 # a row with no cached prefix
        q5 = torch.randn(n, s_suf, hkv, g, hd, generator=gen).to(DEVICE, dt)
        ksf = torch.randn(n, s_suf, hkv, hd, generator=gen).to(DEVICE, dt)
        vsf = torch.randn(n, s_suf, hkv, hd, generator=gen).to(DEVICE, dt)
        sargs = (q5, ksf, vsf, kq, vq, stable, starts)
        skw = dict(prefix_width=w_pfx, pool_k_scale=ks, pool_v_scale=vs)
        sshape = f"n{n} S{s_suf} start{start} W{w_pfx} Hkv{hkv} G{g} hd{hd}"
        out = ops.suffix_prefill_attention(*sargs, **skw)
        e_suf = compare("suffix_prefill_int8", dt, sshape, out, _plain_suffix(*sargs, **skw),
                        ops.suffix_prefill_attention(q5, ksf, vsf, kd, vd, stable, starts,
                                                     prefix_width=w_pfx),
                        faults_of("suffix", sargs, skw))
        if label != "path":
            rows["paged_decode_int8"]["max_abs_err"] = max(
                rows["paged_decode_int8"]["max_abs_err"], e_dec)
            rows["suffix_prefill_int8"]["max_abs_err"] = max(
                rows["suffix_prefill_int8"]["max_abs_err"], e_suf)
            continue
        # times at the path shape. Library call: scaled_dot_product_attention
        # over the gathered K/V dequantized beforehand (a yardstick with the
        # dequantization left out; the port never calls it)
        elem = 2
        live_d = [-(-(p + 1) // page) for p in pos_list]
        kg = ref.gather_pages_ref(kd, table[:, : max(live_d)]).transpose(1, 2)
        vg = ref.gather_pages_ref(vd, table[:, : max(live_d)]).transpose(1, 2)
        mask = torch.arange(max(live_d) * page, device=DEVICE)[None, :] <= pos[:, None].long()
        qs = q.reshape(b, hkv, 1, hd)
        spans = [p + 1 for p in pos_list]
        uniq = _unique_tokens(table, spans, page)
        ms, wall = timed_ms(lambda: ops.paged_decode_attention(*dargs, **dkw))
        rows["paged_decode_int8"] = dict(
            max_abs_err=e_dec, ms=ms, wrapper_ms=wall,
            plain_ms=timed_ms(lambda: _plain_decode(*dargs, **dkw))[0],
            library_ms=timed_ms(lambda: F.scaled_dot_product_attention(
                qs, kg, vg, attn_mask=mask[:, None, None, :]))[0],
            # q and out; each distinct live slot's int8 K and V rows (1 B per
            # element) and their f32 scales once; pos and live table entries
            bytes=2 * b * hkv * hd * elem + 2 * uniq * hkv * (hd + 4) + 4 * (b + sum(live_d)),
            flops=4 * sum(spans) * hkv * hd,
        )
        kc = torch.cat([ref.gather_pages_ref(kd, stable[:, :w_pfx]), ksf], 1).transpose(1, 2)
        vc = torch.cat([ref.gather_pages_ref(vd, stable[:, :w_pfx]), vsf], 1).transpose(1, 2)
        kpos = torch.arange(start + s_suf, device=DEVICE)
        smask = kpos[None, :] <= start + torch.arange(s_suf, device=DEVICE)[:, None]
        qt = q5.reshape(n, s_suf, hkv, hd).transpose(1, 2)
        suniq = _unique_tokens(stable, [start] * n, page)
        ms, wall = timed_ms(lambda: ops.suffix_prefill_attention(*sargs, **skw))
        rows["suffix_prefill_int8"] = dict(
            max_abs_err=e_suf, ms=ms, wrapper_ms=wall,
            plain_ms=timed_ms(lambda: _plain_suffix(*sargs, **skw))[0],
            library_ms=timed_ms(lambda: F.scaled_dot_product_attention(qt, kc, vc,
                                                                       attn_mask=smask))[0],
            # q, suffix k/v and out per row; each distinct prefix slot's int8
            # K and V rows and scales once; starts and the prefix table entries
            bytes=4 * n * s_suf * hkv * hd * elem + 2 * suniq * hkv * (hd + 4)
            + 4 * n * (1 + w_pfx),
            flops=4 * n * hkv * hd * (s_suf * start + s_suf * (s_suf + 1) // 2),
        )
        del kg, vg, kc, vc

    write_rows, write_errs = _pool_write_rows(smi, gen)

    # --- int8_encode, the flat encoder (``ops.int8_encode_leaf``), at the
    # embedding leaf in rows of 256 (fp32), with a planted fault (divisor 128)
    def enc_fault(x, r):
        xf = x.reshape(-1, r).float()
        amax = xf.abs().amax(dim=1)
        sc = (amax / amax.new_tensor(128.0)).clamp(min=1e-12)
        return torch.round(xf / sc[:, None]).clamp(-127, 127).to(torch.int8), sc

    from repro_torch.kernels.quantize import int8_encode

    what, r = "embedding leaf 802816x256 fp32", 256
    x = torch.randn(100352 * 2048, generator=torch.Generator(device=DEVICE).manual_seed(4),
                    device=DEVICE) * 1e-3
    got = int8_encode(x)
    want = ref.int8_encode_ref(x.reshape(-1, r))
    fq, fs = enc_fault(x, r)
    same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    caught = not (torch.equal(got[0], fq) and torch.equal(got[1], fs))
    expect(same, f"int8_encode {what}: kernel differs from the plain version")
    expect(caught, f"int8_encode {what}: planted fault 'divisor 128' not caught")
    e = max((got[0].int() - want[0].int()).abs().max().item(),
            (got[1] - want[1]).abs().max().item())
    log(f"[int8] int8_encode {what}: q and scale bitwise equal {same}, max_abs_err {e:.3e}; "
        f"planted fault 'divisor 128' differs: {caught}")
    del got, want, fq, fs
    n_el = x.numel()
    ms, wall = timed_ms(lambda: int8_encode(x))
    rows["int8_encode"] = dict(
        max_abs_err=e, ms=ms, wrapper_ms=wall,
        plain_ms=timed_ms(lambda: ref.int8_encode_ref(x.reshape(-1, r)), iters=5)[0],
        library_ms=None,
        # x read once, q and one f32 scale per row written once
        bytes=n_el * x.element_size() + n_el + 4 * (n_el // r),
        flops=3 * n_el,
    )
    del x
    torch.cuda.empty_cache()
    named = [*((k, rows[k]) for k in ("paged_decode_int8", "suffix_prefill_int8")),
             ("int8_encode " + what, rows["int8_encode"]),
             *(("kv_write_int8 " + k, v) for k, v in write_rows.items())]
    for what, r in named:
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        fp32 = what.startswith(("int8_encode", "kv_write_int8"))
        t_ops = r["flops"] / (FP32_FLOPS if fp32 else BF16_FLOPS) * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"[int8] {what} ({smi}): kernel device ms {r['ms']:.4f} (wrapper wall "
            f"{r['wrapper_ms']:.4f}) plain_ms {r['plain_ms']:.4f} library_ms {lib} bound_ms "
            f"{r['bound_ms']:.6f} ({r['bound_by']}: {r['bytes']} B)")
    # the kernels line carries the decode step's pool write, the shape of
    # almost every main-path launch; the suffix write is logged above
    rows["kv_write_int8"] = dict(write_rows["decode write 8x32 bf16"], max_abs_err=max(write_errs))
    return rows


# ----------------------------------------------------------------- phase 3c
def _ring_plain(q, k, v, pos, window=0, fault=None, scale=None):
    """The plain ring decode (``ref.swa_decode_ref``'s mask and softmax),
    optionally with one planted fault in its mask: "newest" leaves out the
    key at slot pos mod C (a mask shifted by one key); "nowrap" reconstructs
    gpos without the mod wrap (keys written in an earlier lap drop out);
    "lastpage" leaves out the ring page (``ring_page(C)`` keys) holding the
    newest key."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_decode import ring_page

    b, cap = k.shape[:2]
    pos = ref._row_pos(pos, b, q.device)
    valid = ref._ring_valid(pos, cap, window)
    slots = torch.arange(cap, device=q.device)[None, :]
    newest = (pos % cap)[:, None]
    if fault == "newest":
        valid &= slots != newest
    elif fault == "nowrap":
        valid &= slots <= newest
    elif fault == "lastpage":
        page = ring_page(cap)
        valid &= slots // page != newest // page
    return ref._attend(q[:, None], k, v, valid[:, None, None, None, :], scale)[:, 0]


def _plain_ring(q, k, v, pos, window=0, *, paged=True, scale=None):
    """ops.swa_decode_attention's plain route on any device."""
    return _ring_plain(q, k, v, pos, window, scale=scale)


def _ring_fault(kind):
    def fn(q, k, v, pos, window=0, *, paged=True, scale=None):
        return _ring_plain(q, k, v, pos, window, fault=kind, scale=scale)
    return fn


RING_FAULTS = (("mask shifted by one key", "newest"), ("ring offset without the mod wrap",
               "nowrap"), ("last live page dropped", "lastpage"))
# The faults each phase-3c shape must catch. The missing mod wrap cannot
# change the output where no row has wrapped (the GQA shape) or where the
# newest key sits in the ring's last slot (long_500k: 524287 mod 8192 =
# 8191): there it is printed, not gated.
RING_FAULTS_GATED = {"path": ("newest", "nowrap", "lastpage"),
                     "long_500k": ("newest", "lastpage"), "gqa": ("newest", "lastpage"),
                     "batch": ("newest", "nowrap", "lastpage")}


def _unrolled(k, v, pos, window):
    """Rings (B, C, Hkv, hd) unrolled to position order up to each row's
    live span (min(pos + 1, C, window) keys ending at pos), padded to the
    longest: (K, V as (B, Hkv, L, hd), key mask (B, L))."""
    import torch

    b, cap = k.shape[:2]
    spans = [min(int(p) + 1, cap, window or cap) for p in pos.tolist()]
    n = max(spans)
    idx = torch.zeros(b, n, dtype=torch.long)
    mask = torch.zeros(b, n, dtype=torch.bool)
    for r, (p, span) in enumerate(zip(pos.tolist(), spans)):
        idx[r, :span] = torch.arange(p - span + 1, p + 1) % cap
        mask[r, :span] = True
    idx = idx.to(k.device)[:, :, None, None].expand(-1, -1, *k.shape[2:])
    return (k.gather(1, idx).transpose(1, 2).contiguous(),
            v.gather(1, idx).transpose(1, 2).contiguous(), mask.to(k.device), spans)


def _as_pool(k, v, page, gen):
    """The rings (B, C, Hkv, hd) as a shared pool of pages of ``page`` keys
    at scattered physical pages (page 0 left as scratch) and the (B, C/page)
    table that maps each row's logical pages to them."""
    import torch

    b, cap = k.shape[:2]
    t_w = cap // page
    table = (torch.randperm(b * t_w, generator=gen) + 1).reshape(b, t_w).to(torch.int32)
    table = table.to(k.device)
    pools = []
    for ring in (k, v):
        pool = ring.new_zeros(b * t_w + 1, page, *ring.shape[2:])
        pool[table.long().reshape(-1)] = ring.reshape(b * t_w, page, *ring.shape[2:])
        pools.append(pool)
    return pools[0], pools[1], table


def phase_kernels_ring(smi):
    """``paged_decode_ring`` and ``swa_decode`` against their plain versions
    and against each other (BITWISE), with planted faults, at the ring
    path's shape (B 4, Hkv 32, G 1, hd 64, bf16, C 4096, window 4096, two
    rows short of the ring and two wrapped), at long_500k's (B 1, C 8192,
    pos 524287), at the single-batch path's (B 4, C = window = 96, every
    row wrapped; a scalar pos and per-row ones) and at a GQA shape (G 4, hd
    128, bf16 and f32, a scalar pos and a window shorter than C). Times
    (kernels, plain version, and ``scaled_dot_product_attention`` over the
    rings unrolled to position order, a yardstick only) at the first two
    shapes. The table kernel
    (``paged_decode``) over a pool holding the same rings in scattered pages
    of 16 must give bitwise the ring kernels' output too."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.paged_decode import paged_decode_ring, ring_page
    from repro_torch.kernels.swa_decode import swa_decode

    gen = torch.Generator().manual_seed(3)
    rows = {}
    shapes = [
        ("path", torch.bfloat16, 4, 32, 1, 64, 4096, 4096, [200, 700, 5000, 6500]),
        ("long_500k", torch.bfloat16, 1, 32, 1, 64, 8192, 8192, [524287]),
        ("batch", torch.bfloat16, 4, 32, 1, 64, 96, 96, 127),
        ("batch", torch.bfloat16, 4, 32, 1, 64, 96, 96, [96, 100, 113, 127]),
        ("gqa", torch.bfloat16, 4, 8, 4, 128, 2048, 1000, 1500),
        ("gqa", torch.float32, 4, 8, 4, 128, 2048, 1000, 1500),
    ]
    for label, dt, b, hkv, g, hd, cap, window, pos_arg in shapes:
        q = torch.randn(b, hkv, g, hd, generator=gen).to(DEVICE, dt)
        k = torch.randn(b, cap, hkv, hd, generator=gen).to(DEVICE, dt)
        v = torch.randn(b, cap, hkv, hd, generator=gen).to(DEVICE, dt)
        pos = torch.tensor(pos_arg, dtype=torch.int32, device=DEVICE)
        pos_b = pos.reshape(-1).expand(b).contiguous()   # what ops does with a scalar
        dname = str(dt).split(".")[-1]
        shape = (f"{label} B{b} Hkv{hkv} G{g} hd{hd} C{cap} window{window} pos "
                 f"{pos.tolist()}")
        paged = paged_decode_ring(q, k, v, pos_b, window)
        swa = swa_decode(q, k, v, pos_b, window)
        plain = _ring_plain(q, k, v, pos, window)
        tol = RTOL[dname]
        rms = plain.float().pow(2).mean().sqrt().item()
        same = torch.equal(paged, swa) and all(
            torch.equal(paged_decode_ring(q, k, v, pos_b, window, page=pg), swa)
            for pg in (64, 128, 256, 512) if cap % pg == 0)
        expect(same, f"ring kernels {dname} {shape}: paged_decode_ring (at every page) not "
                     "bitwise equal to swa_decode")
        pk, pv, table = _as_pool(k, v, 16, gen)
        same_table = torch.equal(ops.paged_decode_attention(q, pk, pv, pos_b, table, window), swa)
        expect(same_table, f"ring kernels {dname} {shape}: the table kernel over the same keys "
                           "in pool pages is not bitwise equal")
        msg = (f"[ring] {dname} {shape}: bitwise paged == swa at pages 64..512: {same}; "
               f"table kernel over the same keys in pages of 16 == swa: {same_table}")
        page = ring_page(cap)
        live = [min(-(-(min(p + 1, cap)) // page) * page, cap) for p in pos_b.tolist()]
        msg += (f"; paged_decode_ring: {_split_plan(cap, q.shape, live)}; swa_decode: "
                f"{_split_plan(cap, q.shape, [cap] * b)}")
        if label == "path":
            calls = {
                "paged_decode_ring": lambda r: paged_decode_ring(
                    q[r].contiguous(), k[r].contiguous(), v[r].contiguous(), pos_b[r].contiguous(),
                    window),
                "swa_decode": lambda r: swa_decode(
                    q[r].contiguous(), k[r].contiguous(), v[r].contiguous(), pos_b[r].contiguous(),
                    window),
                "paged_decode over the same keys": lambda r: ops.paged_decode_attention(
                    q[r].contiguous(), pk, pv, pos_b[r].contiguous(), table[r].contiguous(),
                    window),
            }
            for name, call in calls.items():
                alone = _rows_alone(call, b)
                expect(alone, f"{name} {dname} {shape}: a row's output alone differs from its "
                              "output in the batch")
                msg += f"; {name}: each row alone bitwise equal to its output in the batch: {alone}"
        errs = {}
        for name, out in (("paged_decode_ring", paged), ("swa_decode", swa)):
            e = (out.float() - plain.float()).abs().max().item()
            errs[name] = e
            expect(e <= tol * rms, f"{name} {dname} {shape}: err/RMS {e / rms} > {tol}")
            msg += f"; {name} err/RMS {e / rms:.3e} (tol {tol:g})"
        for fname, kind in RING_FAULTS:
            fe = (paged.float() - _ring_plain(q, k, v, pos, window, kind).float()).abs().max()
            fe = fe.item()
            gated = kind in RING_FAULTS_GATED[label]
            msg += (f"; planted fault '{fname}' err/RMS {fe / rms:.3e}"
                    + ("" if gated else " (not gated at this shape)"))
            if gated:
                expect(fe > tol * rms, f"ring {dname} {shape}: planted fault '{fname}' "
                                       "within tolerance")
        log(msg)
        for name in errs:
            if name in rows:
                rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], errs[name])
        if label in ("gqa", "batch"):
            del pk, pv
            continue
        # times; the library call runs over the rings unrolled to position
        # order (a copy made here, outside the timing)
        ku, vu, mask, spans = _unrolled(k, v, pos_b, window)
        qs = q.reshape(b, hkv, 1, hd)
        lib = timed_ms(lambda: F.scaled_dot_product_attention(
            qs, ku, vu, attn_mask=mask[:, None, None, :]))[0]
        plain_ms = timed_ms(lambda: ref.ring_paged_decode_ref(q, k, v, pos_b, window),
                            iters=5)[0]
        elem = q.element_size()
        qo = 2 * b * hkv * g * hd * elem + 4 * b           # q and out, pos
        for name, fn, walked in (("paged_decode_ring", paged_decode_ring, live),
                                 ("swa_decode", swa_decode, [cap] * b)):
            ms, wall = timed_ms(lambda: fn(q, k, v, pos_b, window))
            r = dict(max_abs_err=errs[name], ms=ms, wrapper_ms=wall, plain_ms=plain_ms,
                     library_ms=lib,
                     # the K and V the function needs: each row's live
                     # span (the same for both kernels: their outputs are
                     # bitwise equal), q, out and pos
                     bytes=qo + 2 * sum(spans) * hkv * hd * elem,
                     flops=4 * sum(spans) * hkv * g * hd)
            streamed = qo + 2 * sum(walked) * hkv * hd * elem
            t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
            t_ops = r["flops"] / (BF16_FLOPS if dt == torch.bfloat16 else FP32_FLOPS) * 1e3
            r["bound_ms"] = max(t_bytes, t_ops)
            r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
            log(f"[ring] {name} {label} ({smi}): kernel device ms {ms:.4f} (wrapper wall "
                f"{wall:.4f}) plain_ms {plain_ms:.4f} library_ms {lib:.4f} bound_ms "
                f"{r['bound_ms']:.4f} ({r['bound_by']}: {r['bytes'] / 1e6:.2f} MB, "
                f"{r['flops'] / 1e9:.3f} GFLOP); keys walked {sum(walked)} "
                f"({streamed / 1e6:.2f} MB, {streamed / HBM_BYTES_PER_S * 1e3:.4f} ms at the "
                f"HBM rate), live keys {sum(spans)}")
            if label == "path":
                rows[name] = r
        # the table kernel over the same keys in pool pages of 16: its bound
        # adds the live table entries
        ms, wall = timed_ms(lambda: ops.paged_decode_attention(q, pk, pv, pos_b, table, window))
        pages16 = sum(-(-n // 16) for n in spans)
        t_bytes = (qo + 2 * sum(spans) * hkv * hd * elem + 4 * pages16) / HBM_BYTES_PER_S * 1e3
        read16 = [min(-(-min(p + 1, cap) // 16) * 16, cap) for p in pos_b.tolist()]
        log(f"[ring] paged_decode (table, pages of 16) {label} ({smi}): kernel device ms "
            f"{ms:.4f} (wrapper wall {wall:.4f}) library_ms {lib:.4f} bound_ms {t_bytes:.4f} "
            f"(bytes); {_split_plan(cap, q.shape, read16)}")
        del ku, vu, pk, pv
    return rows


# ------------------------------------------------------------------ phase 4
def phase_golden():
    import torch

    from repro_torch.bridge import numpy_params, params_from_numpy
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import Request, ServeEngine
    from repro_torch.models.model import build_model

    g = json.loads((ROOT / "src/repro_torch/testdata/golden_stablelm_smoke.json").read_text())
    cfg = dataclasses.replace(get_smoke_config("stablelm-1.6b"), dtype="float32")
    params = params_from_numpy(numpy_params(cfg, g["seed"]), cfg, DEVICE)
    eng = ServeEngine(build_model(cfg), params, device=DEVICE, **g["engine"])
    before = dict(ops.LAUNCHES)
    outs = eng.run([Request(uid=u, prompt=p, max_new_tokens=g["max_new_tokens"])
                    for u, p in enumerate(g["prompts"])])
    torch.cuda.synchronize()
    launched = {k: ops.LAUNCHES[k] - before[k] for k in SERVING}
    got = [o.tokens for o in outs]
    check(got == g["tokens"], f"golden fp32 tokens differ from the reference:\n{got}\n"
                              f"{g['tokens']}")
    check(all(v > 0 for v in launched.values()), f"golden run missed a kernel: {launched}")
    log(f"[golden] {len(got)} requests, fp32 greedy tokens identical to the reference "
        f"engine's; kernel launches {launched}")


# ----------------------------------------------------------------- phase 4b
GOLDEN_INT8_COUNTERS = ("preemptions", "swapped_out_pages", "swapped_in_pages",
                        "host_demoted_pages", "host_promote_hits", "prefill_tokens",
                        "cow_copies")


def phase_golden_int8():
    """The reference engine's float32 int8 + host-tier trace: tokens and
    every counter must be reproduced exactly."""
    import torch

    from repro_torch.bridge import numpy_params, params_from_numpy
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import Request, ServeEngine
    from repro_torch.models.model import build_model

    g = json.loads((ROOT / "src/repro_torch/testdata/golden_stablelm_smoke_int8_swap.json")
                   .read_text())
    cfg = dataclasses.replace(get_smoke_config("stablelm-1.6b"), dtype="float32")
    params = params_from_numpy(numpy_params(cfg, g["seed"]), cfg, DEVICE)
    eng = ServeEngine(build_model(cfg), params, device=DEVICE, **g["engine"])
    before = dict(ops.LAUNCHES)
    outs = eng.run([Request(uid=u, prompt=p, max_new_tokens=g["max_new_tokens"])
                    for u, p in enumerate(g["prompts"])])
    torch.cuda.synchronize()
    launched = {k: ops.LAUNCHES[k] - before[k] for k in SERVING_INT8}
    got = [o.tokens for o in outs]
    counters = {k: eng.pool_stats[k] for k in g["counters"]}
    check(got == g["tokens"], f"golden int8 tokens differ from the reference:\n{got}\n"
                              f"{g['tokens']}")
    check(counters == g["counters"], f"golden int8 counters differ from the reference: "
                                     f"{counters} vs {g['counters']}")
    check(all(g["counters"][k] > 0 for k in GOLDEN_INT8_COUNTERS),
          f"the golden int8 trace leaves a counter at 0: {g['counters']}")
    check(all(v > 0 for v in launched.values()), f"golden int8 run missed a kernel: {launched}")
    log(f"[golden-int8] {len(got)} requests, fp32 int8 + host-tier greedy tokens identical to "
        f"the reference engine's, counters equal {counters}; kernel launches {launched}")


# ------------------------------------------------------------------ phase 5
def _main_path_requests(vocab):
    from repro_torch.launch.engine import Request

    rng = np.random.default_rng(7)
    prefix = rng.integers(0, vocab, 256, dtype=np.int32)
    cold = []
    for u, n in enumerate(rng.integers(96, 385, 8)):
        p = rng.integers(0, vocab, int(n), dtype=np.int32)
        if u == 0:  # its retirement publishes the shared prefix's 16 pages
            p = np.concatenate([prefix, rng.integers(0, vocab, 64, dtype=np.int32)])
        cold.append(Request(uid=u, prompt=p, max_new_tokens=32))
    hits = [Request(uid=8 + j, max_new_tokens=32, prompt=np.concatenate(
        [prefix, rng.integers(0, vocab, int(rng.integers(32, 65)), dtype=np.int32)]))
        for j in range(8)]
    return cold, hits


def _parity_rounds(cold, hits):
    """The inputs of the logit-parity stages (8 slots, page 16, a 52-page
    table): the cold round's table, tokens and lengths over the 8 cold
    prompts, and the suffix round's over the 8 shared-prefix prompts, which
    reuse cold row 0's 16 prefix pages and get fresh pages behind them."""
    import torch

    from repro_torch.launch.engine import bucket_length, bucket_pages

    page, n = 16, 8
    table = np.zeros((n, 52), np.int32)
    nxt = 1
    cold_len = [len(r.prompt) for r in cold]
    for i, length in enumerate(cold_len):
        k = -(-(length + 1) // page)
        table[i, :k] = np.arange(nxt, nxt + k)
        nxt += k
    tokens = np.zeros((n, bucket_length(max(cold_len))), np.int32)
    for i, r in enumerate(cold):
        tokens[i, : len(r.prompt)] = r.prompt
    suf = [r.prompt[256:] for r in hits]
    table_h = np.zeros((n, 52), np.int32)
    for i, p in enumerate(suf):
        k = -(-(256 + len(p)) // page)
        table_h[i, :16] = table[0, :16]
        table_h[i, 16:k] = np.arange(nxt, nxt + k - 16)
        nxt += k - 16
    stoks = np.zeros((n, bucket_length(max(len(p) for p in suf))), np.int32)
    for i, p in enumerate(suf):
        stoks[i, : len(p)] = p

    def t(a):
        return torch.from_numpy(np.asarray(a)).to(DEVICE)

    return dict(table=table, tokens=t(tokens), lengths=t(cold_len), table_h=table_h,
                stoks=t(stoks), slens=t([len(p) for p in suf]),
                starts=t(np.full(n, 256, np.int32)), pw=bucket_pages(16, 52),
                slots=torch.arange(n, device=DEVICE))


@contextlib.contextmanager
def _moe_routes(record: list | None = None, replay: list | None = None):
    """Record every MoE layer's routing (``models/moe.route``: slots, kept
    choices, weights) in call order, or replay a record in its place,
    counting the (token, expert) choices the replaying run's own routing
    would have kept otherwise (yielded: a list, one count per layer)."""
    from repro_torch.models import moe

    route, calls, moved = moe.route, iter(replay or ()), []

    def pinned(params, xf, cfg, aux=True):
        own = route(params, xf, cfg, aux)
        if replay is None:
            record.append(own)
            return own
        slot, kept, weight, _ = next(calls)
        moved.append(int((own[1] != kept).sum()))
        return slot, kept, weight, own[3]

    moe.route = pinned
    try:
        yield moved
    finally:
        moe.route = route


def _logit_parity(model, params, cfg, cold, hits, kv_dtype="fp"):
    """A cold round over the 8 cold prompts, one decode step and a suffix
    round over the 8 shared-prefix prompts, on the card, over an fp or an
    int8 pool. Each stage runs through the kernels, then from a copy of the
    same cache through the plain versions and through each planted fault of
    its kernel.

    An MoE model's plain and faulted runs take the kernel run's routing
    (``_moe_routes``): a router's top-k is a step function of its input, so
    a one-ulp difference in an attention output moves a near-tied token to
    another expert and its logits by O(1) (olmoe-1b-7b's cold round read
    0.26 x scale with each run routing itself; NVIDIA H100 80GB HBM3,
    700.00 W). Pinned, the comparison reads the kernels; the choices each
    plain run would have moved are printed. An MoE model in bf16 is held to
    ``LOGIT_RTOL_MOE_BF16``, which its one-dropped-prefix-key fault
    passes."""
    import torch

    page, n = 16, 8
    cache = model.init_paged_cache(n, 2 * 26 * n + 1, page, 52, device=DEVICE, kv_dtype=kv_dtype)
    r = _parity_rounds(cold, hits)
    cache["table"].copy_(torch.from_numpy(r["table"]))

    moe = cfg.arch_type == "moe"

    def stage(what, run, faults):
        snap = {k: v.clone() for k, v in cache.items()}
        routes = []
        with _moe_routes(record=routes) if moe else contextlib.nullcontext():
            _, lk = run(cache)
        lk = lk[:, : cfg.vocab_size]
        check(bool(torch.isfinite(lk).all()), f"{what}: non-finite logits")
        got, moved = {}, []
        for fname, swap in [("plain", {}), *faults]:
            twin = {k: v.clone() for k, v in snap.items()}
            with plain_kernels(**swap), (_moe_routes(replay=routes) if moe
                                         else contextlib.nullcontext([])) as m:
                _, lp = run(twin)
            if fname == "plain":
                moved = m
            got[fname] = lp[:, : cfg.vocab_size]
            del twin
        del snap, routes
        tol = LOGIT_RTOL_MOE_BF16 if moe and cfg.dtype == "bfloat16" else LOGIT_RTOL[cfg.dtype]
        scale = max(got["plain"].abs().max().item(), 1.0)
        d = (lk - got["plain"]).abs().max().item()
        agree = (lk.argmax(-1) == got["plain"].argmax(-1)).float().mean().item()
        msg = (f"[main] {cfg.name} {cfg.dtype} {kv_dtype} {what}: kernel vs plain max |dlogit| "
               f"{d:.3e} = "
               f"{d / scale:.3e} x logit scale {scale:.2f} (tol {tol:g} x scale), argmax "
               f"agreement {agree:.2f}"
               + (f"; routing pinned to the kernel run's, the plain run's own would have moved "
                  f"{sum(moved)} (token, expert) choices over {len(moved)} layers" if moe else ""))
        expect(d <= tol * scale, f"{cfg.name} {cfg.dtype} {what}: logit diff {d} too large")
        for fname, _ in faults:
            fd = (lk - got[fname]).abs().max().item()
            msg += f"; planted fault '{fname}' {fd:.3e} = {fd / scale:.3e} x scale"
            expect(fd > tol * scale, f"{cfg.name} {cfg.dtype} {what}: planted fault '{fname}' "
                                     "within tolerance")
        log(msg)
        return lk

    lk = stage("cold round", lambda c: model.prefill_slots(params, c, r["tokens"], r["lengths"],
                                                           r["slots"]),
               [("mask shifted by one", dict(flash_prefill=_prefill_shift))])
    feed = lk.argmax(-1, keepdim=True).to(torch.int32)
    int8_faults = ([("scale from the next slot", dict(paged_decode=_decode_scale_slot))]
                   if kv_dtype == "int8" else [])
    stage("decode step", lambda c: model.decode(params, c, feed),
          [("mask shifted by one", dict(paged_decode=_decode_shift)),
           ("last live page dropped", dict(paged_decode=_decode_drop_page)), *int8_faults])
    cache["table"].copy_(torch.from_numpy(r["table_h"]))
    stage("suffix round", lambda c: model.prefill_slots(params, c, r["stoks"], r["slens"],
                                                        r["slots"], starts=r["starts"],
                                                        prefix_pages=r["pw"]),
          [("last prefix key dropped", dict(suffix_prefill=_suffix_shift)),
           ("last prefix page dropped", dict(suffix_prefill=_suffix_drop_page)),
           *([("scale from the next slot", dict(suffix_prefill=_suffix_scale_slot))]
             if kv_dtype == "int8" else [])])


def _numel(tree) -> int:
    from repro_torch.utils.tree import tree_leaves

    return sum(x.numel() for x in tree_leaves(tree))


def _nbytes(tree) -> int:
    from repro_torch.utils.tree import tree_leaves

    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def _cast(tree, dtype):
    from repro_torch.utils.tree import tree_map

    return tree_map(lambda x: x.to(dtype), tree)


def _kernel_rows(prof):
    """The profiler's kernel rows only: an operator's row repeats the time of
    the kernels it launched."""
    import torch

    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]


def _profile_decode(eng, smi, n=5, label="profile"):
    """Host wall time and device time of one batched decode step (all the
    engine's slots, its cache as the trace left it) through the engine's own
    dispatch (``ServeEngine.decode_step``: a graph replay, or with
    ``graphs=False`` eager launches), and the kernels it launches. Returns
    the port's kernel launches in one step, by entry point (the wrappers'
    counts, replays included; nonzero ones only)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops

    feed = np.zeros((eng.num_slots, 1), np.int32)

    def step():
        eng.decode_step(feed)

    mode = "graphed" if eng.graphs.graphed else "eager"
    ops.reset_launches()
    step()
    torch.cuda.synchronize()
    per_step = {k: c for k, c in ops.LAUNCHES.items() if c}
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    events = _kernel_rows(prof)
    tail = (f"; the port's kernels per step {per_step}; compiles {eng.compiles}; graph pool "
            f"{_pool_gb(eng)}")
    if not events:
        log(f"[{label}, {mode}] {smi}: decode step host wall {host_ms:.2f} ms; device time not "
            f"measured (the profiler saw no kernels){tail}")
        return per_step
    dev_ms = sum(e.self_device_time_total for e in events) / n / 1e3
    launches = sum(e.count for e in events) / n
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
    log(f"[{label}, {mode}] {smi}: decode step host wall {host_ms:.2f} ms, device time "
        f"{dev_ms:.3f} ms in {launches:.0f} kernel records, device idle share "
        f"{1 - dev_ms / host_ms:.3f}; top: "
        + "; ".join(f"{e.key[:40]} x{e.count // n} {e.self_device_time_total / n / 1e3:.3f}"
                    " ms" for e in top) + tail)
    return per_step


def _pool_gb(eng) -> str:
    """The engine's graph memory pool, for the log."""
    b = eng.graphs.pool_bytes()
    return "not measured" if b is None else f"{b / 1e9:.3f} GB in {eng.graphs.graphs} graphs"


# Entry points whose output is logits (the finite checks read each call's).
LOGIT_ENTRIES = ("decode", "prefill_slots", "prefill_suffix", "spec_verify")


def _tap(eng, finite: list | None = None, store: dict | None = None, nth: int = 2):
    """Instrument every dispatch of ``eng`` (graph replays included) through
    its graph cache's tap: append to ``finite`` whether every real-vocabulary
    logit of each logit entry's output is finite (a device bool, read once
    at the end of the run; taken before any other graph replays), and leave
    in ``store`` the ``nth`` verify dispatch's starting cache, its
    ``prefill_slots`` arguments and its logits."""
    import torch

    vocab = eng.cfg.vocab_size
    verifies = [0]

    def tap(entry, static, inputs, call):
        grab = False
        if store is not None and entry == "spec_verify":
            verifies[0] += 1
            grab = verifies[0] == nth
        if grab:
            store["cache"] = {k: v.clone() for k, v in eng.cache.items()}
            t, n, sl, st = (x.to(DEVICE) for x in inputs)
            store["args"] = ((t, n, sl), dict(starts=st, prefix_pages=static[0],
                                              return_all_logits=True))
        out = call()
        if finite is not None and entry in LOGIT_ENTRIES:
            finite.append(torch.isfinite(out[..., :vocab]).all())
        if grab:
            store["logits"] = out.clone()
        return out

    eng.graphs.tap = tap


def _round_timer(eng) -> list:
    """Host wall of each speculative round of ``eng`` (draft, verify,
    acceptance and rollback; seconds), appended to the returned list."""
    walls = []
    fn = eng._spec_round

    def timed(live):
        t = time.perf_counter()
        fn(live)
        walls.append(time.perf_counter() - t)

    eng._spec_round = timed
    return walls


def _twin_gate(label, smi, a: dict, b: dict) -> None:
    """The graphed run ``a`` against the eager run ``b`` of one trace: tokens,
    counters and kernel launches (replay-accounted against eager) equal, and
    the specializations the same; print both runs."""
    same = {k: a[k] == b[k] for k in ("tokens", "counters", "launches", "compiles")}
    for k, ok in same.items():
        expect(ok, f"graphs vs eager, {label}: {k} differ:\n{a[k]}\n{b[k]}")
    log(f"[graphs] {label} ({smi}): graphed vs eager: tokens, counters, launches (kernel by "
        f"kernel) and compiles equal: {same}; tok/s {a['tok_s']:.1f} vs {b['tok_s']:.1f}, "
        f"TTFT p50 {a['ttft'] * 1e3:.1f} vs {b['ttft'] * 1e3:.1f} ms"
        + (f", spec round wall p50 {a['round_ms']:.2f} vs {b['round_ms']:.2f} ms"
           if a.get("round_ms") is not None else "")
        + f"; compiles {a['compiles']}; graph pool {a['pool']}")


def _record(outs, wall, eng, launches, rounds=None) -> dict:
    """One trace's results for ``_twin_gate``: tokens by uid, the engine's
    counters, launches, tok/s, TTFT p50, compiles, the spec round's wall."""
    ps = eng.pool_stats or {}
    counters = dict(ps, steps=eng.steps, prefill_dispatches=eng.prefill_dispatches,
                    prefill_tokens=eng.prefill_tokens)
    outs = outs.values() if isinstance(outs, dict) else outs
    toks = {o.uid: o.tokens for o in outs}
    return dict(tokens=toks, counters=counters, launches=launches, compiles=eng.compiles,
                tok_s=sum(len(t) for t in toks.values()) / wall,
                ttft=float(np.percentile([o.ttft for o in outs], 50)),
                round_ms=float(np.median(rounds)) * 1e3 if rounds else None,
                pool=_pool_gb(eng))


def phase_main_path(smi):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import ServeEngine
    from repro_torch.models.model import build_model

    cfg = get_config("stablelm-1.6b")
    model = build_model(cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = model.init(gen, DEVICE)
    n_params = _numel(params)
    log(f"[main] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads, "
        f"hd {cfg.resolved_head_dim}, vocab {cfg.vocab_size}, {cfg.dtype}, "
        f"{n_params / 1e9:.2f} B parameters")
    cold, hits = _main_path_requests(cfg.vocab_size)
    _logit_parity(model, params, cfg, cold, hits)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = _cast(params, torch.float32)
    _logit_parity(build_model(cfg32), params32, cfg32, cold, hits)
    del params32
    torch.cuda.empty_cache()

    def run_trace(graphs):
        eng = ServeEngine(model, params, num_slots=8, max_seq=384 + 32, page_size=16,
                          prefix_cache=True, paged_cache=True, device=DEVICE, graphs=graphs)
        eng.warm(sorted({len(r.prompt) for r in cold}), gen_tokens=2)
        warmed = eng.compiles
        finite = []
        _tap(eng, finite)
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        outs = []
        for group in (cold, hits):  # the second group arrives once the first retired
            eng.reset_clock()
            outs += eng.run(group)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        eng.graphs.tap = None
        check(bool(torch.stack(finite).all()), "non-finite logits")
        check(eng.compiles["decode"] == 1, f"decode specialized more than once: {eng.compiles}")
        check(eng.compiles["prefill_slots"] == warmed["prefill_slots"],
              f"the timed trace added a prefill_slots specialization after warm(): "
              f"{warmed} -> {eng.compiles}")
        return outs, wall, eng, dict(ops.LAUNCHES)

    outs, wall, eng, all_launches = run_trace(True)
    launches = {k: all_launches[k] for k in SERVING}
    ps = eng.pool_stats
    check(len(outs) == 16 and all(len(o.tokens) == 32 for o in outs),
          "not every request finished with 32 tokens")
    check(ps["suffix_dispatches"] > 0 and ps["cold_dispatches"] > 0,
          f"dispatch split not exercised: {ps}")
    check(ps["prefix_hit_rate"] > 0, "no prefix hit")
    check(all(v > 0 for v in launches.values()), f"a kernel never launched: {launches}")
    check(all_launches["kv_write_int8"] == all_launches["int8_encode"] == 0,
          f"the fp trace ran an int8 pool write: {all_launches}")
    tokens = sum(len(o.tokens) for o in outs)
    ttft = float(np.percentile([o.ttft for o in outs], 50))
    lat = float(np.percentile([o.latency for o in outs], 50))
    log(f"[main] {smi}: 16 requests x 32 tokens in {wall:.3f} s: {tokens / wall:.1f} tok/s, "
        f"TTFT p50 {ttft * 1e3:.1f} ms, latency p50 {lat * 1e3:.1f} ms; {eng.steps} decode "
        f"steps, {ps['cold_dispatches']} cold + {ps['suffix_dispatches']} suffix dispatches, "
        f"prefix hit rate {ps['prefix_hit_rate']:.3f}, {ps['cow_copies']} CoW, "
        f"{ps['preemptions']} preemptions; launches {launches}; compiles {eng.compiles}")
    graphed = _record(outs, wall, eng, all_launches)
    _profile_decode(eng, smi)
    # 5g: the same trace with every dispatch eager
    e_outs, e_wall, eager, e_launches = run_trace(False)
    _twin_gate("fp pages", smi, graphed, _record(e_outs, e_wall, eager, e_launches))
    _profile_decode(eager, smi)
    # the timed trace above captured its suffix round's graph (a shape that
    # warm() does not dispatch); once more, every key captured (not gated)
    again, a_wall = _run_trace(eng, dict(cold=cold, hits=hits))
    log(f"[graphs] {_trace_line('fp pages, the trace again on the graphed engine', smi, again, a_wall, eng)}"
        f"; new specializations: {eng.compiles != graphed['compiles']}")
    trace = dict(model=model, params=params, engine=eng, eager=eager, cold=cold, hits=hits,
                 record=graphed, tokens={o.uid: o.tokens for o in outs}, tok_s=tokens / wall,
                 ttft=ttft,
                 dispatches=(eng.steps + ps["cold_dispatches"] + ps["suffix_dispatches"])
                 / tokens)
    return launches, trace


# ----------------------------------------------------------------- phase 3d
# The speculative k-token verify's shape on the suffix-prefill kernels: 8
# rows of S = bucket_length(k + 1) = 8 queries, 1..5 of them live, with
# starts at every offset within a page of 16 (two calls: offsets 0-7 and
# 8-15) behind prefixes of 64-408 tokens whose first 4 pages all rows share
# (stablelm-1.6b: Hkv 32, G 1, hd 64, bf16; the main path's table width).
VERIFY = dict(n=8, s=8, hkv=32, hd=64, page=16, t_w=208, num_pages=209)
VERIFY_LENS = tuple(1 + r % 5 for r in range(8))


def phase_kernels_verify(smi):
    """``suffix_prefill`` and ``suffix_prefill_int8`` at the verify's shape
    against their plain versions at all S query positions (the kernels take
    no lengths), the int8 kernel also bitwise against the fp kernel over the
    dequantized pool; planted faults (the last prefix key dropped, the last
    prefix page dropped, int8: a scale read from the next token slot) must
    land outside the tolerance. Times the offsets 0-7 call as ``timed_ms``
    does, beside the plain versions and SDPA over the same prefix and suffix
    keys (the pool dequantized beforehand for int8); the bounds count the
    live queries only, each distinct prefix slot once."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.launch.engine import bucket_pages

    n, s, hkv, hd, page, t_w, num_pages = (VERIFY[k] for k in (
        "n", "s", "hkv", "hd", "page", "t_w", "num_pages"))
    gen = torch.Generator().manual_seed(5)
    dt = torch.bfloat16
    kp = torch.randn(num_pages, page, hkv, hd, generator=gen).to(DEVICE, dt)
    vp = torch.randn(num_pages, page, hkv, hd, generator=gen).to(DEVICE, dt)
    kq, ksc = ref.kv_quant_ref(kp)
    vq, vsc = ref.kv_quant_ref(vp)
    kd, vd = ref.dequant_pool_ref(kq, ksc, dt), ref.dequant_pool_ref(vq, vsc, dt)
    sc = dict(pool_k_scale=ksc, pool_v_scale=vsc)
    lens = list(VERIFY_LENS)
    rows = {}

    def compare(name, shape, out, plain, faults):
        tol = RTOL["bfloat16"]
        rms = plain.float().pow(2).mean().sqrt().item()
        e = (out.float() - plain.float()).abs().max().item()
        msg = (f"[verify] {name} bfloat16 {shape}: max_abs_err {e:.3e}, err/RMS {e / rms:.3e} "
               f"(tol {tol:g})")
        expect(e <= tol * rms, f"{name} verify {shape}: err/RMS {e / rms} > {tol}")
        for fname, fout in faults:
            fe = (out.float() - fout.float()).abs().max().item()
            msg += f"; planted fault '{fname}' err/RMS {fe / rms:.3e}"
            expect(fe > tol * rms, f"{name} verify: planted fault '{fname}' within tolerance")
        return e, msg

    for half in (0, 1):
        starts_l = [64 + 48 * r + 8 * half + r for r in range(n)]
        live_pages = [-(-(st + s) // page) for st in starts_l]
        table = _table(gen, live_pages, t_w, num_pages, shared=4).to(DEVICE)
        starts = torch.tensor(starts_l, dtype=torch.int32, device=DEVICE)
        pw = bucket_pages(-(-max(starts_l) // page), t_w)   # the engine's prefix width
        q = torch.randn(n, s, hkv, 1, hd, generator=gen).to(DEVICE, dt)
        ksuf = torch.randn(n, s, hkv, hd, generator=gen).to(DEVICE, dt)
        vsuf = torch.randn(n, s, hkv, hd, generator=gen).to(DEVICE, dt)
        args, args8 = (q, ksuf, vsuf, kp, vp, table, starts), (q, ksuf, vsuf, kq, vq, table,
                                                               starts)
        shape = (f"n{n} S{s} lengths {min(lens)}..{max(lens)} starts {starts_l[0]}..{starts_l[-1]} "
                 f"(offsets {8 * half}-{8 * half + 7} mod {page}) W{pw} Hkv{hkv} G1 hd{hd}")
        e, msg = compare("suffix_prefill", shape,
                         ops.suffix_prefill_attention(*args, prefix_width=pw),
                         ref.suffix_prefill_ref(*args, prefix_width=pw),
                         [("last prefix key dropped", _suffix_shift(*args, prefix_width=pw)),
                          ("last prefix page dropped",
                           _suffix_drop_page(*args, prefix_width=pw))])
        log(msg)
        out8 = ops.suffix_prefill_attention(*args8, prefix_width=pw, **sc)
        same = torch.equal(out8, ops.suffix_prefill_attention(q, ksuf, vsuf, kd, vd, table,
                                                              starts, prefix_width=pw))
        expect(same, f"suffix_prefill_int8 verify {shape}: not bitwise equal to the fp kernel "
                     "over the dequantized pool")
        e8, msg = compare("suffix_prefill_int8", shape, out8,
                          _plain_suffix(*args8, prefix_width=pw, **sc),
                          [("scale from the next slot",
                            _suffix_scale_slot(*args8, prefix_width=pw, **sc)),
                           ("last prefix page dropped",
                            _suffix_drop_page(*args8, prefix_width=pw, **sc))])
        log(msg + f"; bitwise equal to the fp kernel over the dequantized pool: {same}")
        if half:
            continue
        # SDPA over the same keys: the prefix pages gathered, the suffix
        # after them, lanes at or past each row's start masked
        kc = torch.cat([ref.gather_pages_ref(kd, table[:, :pw]), ksuf], 1).transpose(1, 2)
        vc = torch.cat([ref.gather_pages_ref(vd, table[:, :pw]), vsuf], 1).transpose(1, 2)
        lane = torch.arange(pw * page, device=DEVICE)[None, :]
        qpos = starts[:, None].long() + torch.arange(s, device=DEVICE)[None, :]
        kvpos = torch.cat([torch.where(lane < starts[:, None], lane, 1 << 30), qpos], 1)
        mask = (qpos[:, :, None] >= kvpos[:, None, :])[:, None]
        qt = q.reshape(n, s, hkv, hd).transpose(1, 2)
        lib = timed_ms(lambda: F.scaled_dot_product_attention(qt, kc, vc, attn_mask=mask))[0]
        uniq = _unique_tokens(table, starts_l, page)
        n_live = sum(lens)
        pfx_entries = sum(-(-st // page) for st in starts_l)
        flops = 4 * hkv * hd * sum(ln * st + ln * (ln + 1) // 2 for ln, st in zip(lens, starts_l))
        for name, a, kw, plain_fn, elem_pool in (
                ("suffix_prefill", args, {}, ref.suffix_prefill_ref, 2 * hd),
                ("suffix_prefill_int8", args8, sc, _plain_suffix, hd + 4)):
            ms, wall = timed_ms(lambda: ops.suffix_prefill_attention(*a, prefix_width=pw, **kw))
            rows[name] = dict(
                max_abs_err=e if name == "suffix_prefill" else e8, ms=ms, wrapper_ms=wall,
                plain_ms=timed_ms(lambda: plain_fn(*a, prefix_width=pw, **kw))[0],
                library_ms=lib,
                # the live queries' q, suffix k/v and out, each distinct
                # prefix slot's k and v once (int8: q bytes and an f32
                # scale per kv head), starts and the prefix table entries
                bytes=4 * n_live * hkv * hd * 2 + 2 * uniq * hkv * elem_pool
                + 4 * (n + pfx_entries),
                flops=flops)
    for name, r in rows.items():
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["flops"] / BF16_FLOPS * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        log(f"[verify] {name} verify shape ({smi}): kernel device ms {r['ms']:.4f} (wrapper "
            f"wall {r['wrapper_ms']:.4f}) plain_ms {r['plain_ms']:.4f} library_ms "
            f"{r['library_ms']:.4f} bound_ms {r['bound_ms']:.6f} ({r['bound_by']}: "
            f"{r['bytes'] / 1e6:.3f} MB, {r['flops'] / 1e9:.4f} GFLOP; {sum(lens)} live of "
            f"{n * s} queries, {_unique_tokens(table, starts_l, page)} distinct prefix tokens)")
    return rows


# ----------------------------------------------------------------- phase 4d
def phase_golden_spec():
    """The reference engine's float32 speculative traces
    (``golden_stablelm_smoke_spec.json``: a same-params and a foreign draft,
    k = 3, fp and int8 pages, the prefix cache with cold, suffix and
    copy-on-write admissions): tokens, finish reasons and the round counters
    exactly, and the tokens equal to the reference's plain engine's."""
    import torch

    from repro_torch.bridge import numpy_params, params_from_numpy
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import Request, ServeEngine
    from repro_torch.models.model import build_model

    g = json.loads((ROOT / "src/repro_torch/testdata/golden_stablelm_smoke_spec.json")
                   .read_text())
    cfg = dataclasses.replace(get_smoke_config("stablelm-1.6b"), dtype="float32")
    model = build_model(cfg)
    params = params_from_numpy(numpy_params(cfg, g["seed"]), cfg, DEVICE)
    kernels = ("suffix_prefill", "suffix_prefill_int8", "paged_decode_ring", "flash_prefill",
               "kv_write_int8", "paged_decode", "paged_decode_int8")
    for case in g["cases"]:
        eng = ServeEngine(
            model, params, device=DEVICE, **case["engine"], draft_model=model,
            draft_params=params_from_numpy(numpy_params(cfg, case["draft_seed"]), cfg, DEVICE),
            spec_tokens=g["spec_tokens"])
        before = dict(ops.LAUNCHES)
        outs = eng.run([Request(uid=u, prompt=p, max_new_tokens=g["max_new_tokens"])
                        for u, p in enumerate(g["prompts"])])
        torch.cuda.synchronize()
        launched = {k: ops.LAUNCHES[k] - before[k] for k in kernels}
        got = [o.tokens for o in outs]
        counters = {k: eng.pool_stats[k] for k in case["counters"]}
        name = case["name"]
        check(got == case["tokens"], f"golden spec {name}: tokens differ from the reference:\n"
                                     f"{got}\n{case['tokens']}")
        check(case["tokens"] == case["plain_tokens"],
              f"golden spec {name}: the reference's speculative tokens differ from its plain ones")
        check([o.finish_reason for o in outs] == case["finish_reasons"],
              f"golden spec {name}: finish reasons differ")
        check(counters == case["counters"], f"golden spec {name}: counters {counters} differ "
                                            f"from the reference's {case['counters']}")
        verify = "suffix_prefill_int8" if case["engine"]["kv_dtype"] == "int8" else "suffix_prefill"
        check(launched[verify] >= cfg.n_layers * counters["spec_rounds"]
              and launched["paged_decode_ring"] > 0 and launched["flash_prefill"] > 0,
              f"golden spec {name}: the verify or the draft missed a kernel: {launched}")
        log(f"[golden-spec] {name}: {len(got)} requests, fp32 speculative tokens, finish reasons "
            f"and counters {counters} identical to the reference engine's (and its tokens to "
            f"its plain engine's); kernel launches "
            f"{ {k: v for k, v in launched.items() if v} }")
        del eng


# ----------------------------------------------------------------- phase 4e
ROUTER_COUNTERS = ("migrations", "migrated_requests", "affinity_routed", "balance_routed",
                   "retries", "forced_placements", "preemptions", "timeouts", "shed_requests",
                   "replica_requests", "replica_steps", "healthy")
ROUTER_POOL_COUNTERS = ("preemptions", "swapped_out_pages", "swapped_in_pages",
                        "prefix_hit_pages", "cow_copies", "prefill_tokens")


def _router_summary(router) -> dict:
    """What a router run must reproduce of the reference's: tokens, finish
    reasons, sheds, the router's counters, each replica's pool counters and
    slot history (the golden file's keys)."""
    rs = router.router_stats
    outs = sorted(router.finished, key=lambda o: o.uid)
    return {
        "tokens": [[o.uid, [int(t) for t in o.tokens]] for o in outs],
        "finish_reasons": [[o.uid, o.finish_reason] for o in outs],
        "shed": [[e.uid, e.reason] for e in router.shed_errors],
        "counters": {k: rs[k] for k in ROUTER_COUNTERS},
        "pool": [{k: e.pool_stats[k] for k in ROUTER_POOL_COUNTERS} for e in router.engines],
        "slot_history": [sorted([int(u), list(v)] for u, v in e.slot_history.items())
                         for e in router.engines],
    }


def phase_golden_router():
    """4e: the reference router's float32 traces
    (``golden_stablelm_smoke_router.json``: 2 replicas over tight fp pools
    with prefix sharing, staggered arrivals on a virtual clock advanced once
    per router round, a priority pair, a deadline; replica 1 killed without
    host tiers (re-prefill) and stalled with tiers of 32 pages (carried
    pages)): tokens, finish reasons, sheds, the router's counters, each
    replica's preemptions, swaps and slot history exactly."""
    import torch

    from repro_torch.bridge import numpy_params, params_from_numpy
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import Request
    from repro_torch.launch.router import ServeRouter, parse_fault_spec
    from repro_torch.models.model import build_model

    g = json.loads((ROOT / "src/repro_torch/testdata/golden_stablelm_smoke_router.json")
                   .read_text())
    cfg = dataclasses.replace(get_smoke_config("stablelm-1.6b"), dtype="float32")
    model = build_model(cfg)
    params = params_from_numpy(numpy_params(cfg, g["seed"]), cfg, DEVICE)
    for run in g["runs"]:
        clock = [0.0]
        router = ServeRouter(model, params, fault_plan=parse_fault_spec(run["fault"]),
                             time_fn=lambda: clock[0], host_pages=run["host_pages"],
                             device=DEVICE, **g["router"], **g["engine"])
        todo = [Request(uid=q["uid"], prompt=np.asarray(q["prompt"], np.int32),
                        max_new_tokens=q["max_new_tokens"], arrival_time=q["arrival_time"],
                        priority=q["priority"], deadline_s=q["deadline_s"])
                for q in g["requests"]]
        before = dict(ops.LAUNCHES)
        while todo or router.has_work:  # submit at arrival; one round per tick
            while todo and todo[0].arrival_time <= clock[0]:
                router.submit(todo.pop(0))
            router.step()
            clock[0] += 1.0
        torch.cuda.synchronize()
        launched = {k: ops.LAUNCHES[k] - before[k] for k in SERVING}
        got = _router_summary(router)
        for key, val in got.items():
            check(val == run[key], f"golden router {run['name']}: {key} differ from the "
                                   f"reference's:\n{val}\n{run[key]}")
        check(all(v > 0 for v in launched.values()),
              f"golden router {run['name']}: a kernel never launched: {launched}")
        log(f"[golden-router] {run['name']} ({', '.join(run['fault'])}, host tier "
            f"{run['host_pages']} pages): {len(got['tokens'])} requests, fp32 tokens, finish "
            f"reasons, sheds {got['shed']}, router counters {got['counters']}, pool counters "
            f"{got['pool']} and slot histories identical to the reference router's; kernel "
            f"launches {launched}")
        del router


# ----------------------------------------------------------------- phase 4f
def phase_golden_train():
    """4f: the reference trainer's float32 golden traces (fedavg, dynamic,
    gradient, async, nesterov, 2 microbatches; int8 with error feedback and
    DP clip 0.5, so the channel kernels run, on leaves down to 128
    elements) replayed on the card: per-step per-cloud losses within
    ``GOLDEN_TRAIN_RTOL`` and the final global params' checksums within
    ``GOLDEN_TRAIN_SUM_TOL``; with the sample counts ignored the fedavg and
    gradient cases must land outside, and the pod case (the reference's
    pod-mode step, the SPMD codecs and the int8 wire) outside the checksum
    gate."""
    import torch

    from golden_train import (GOLDEN_TRAIN, GOLDEN_TRAIN_FAULTED, GOLDEN_TRAIN_RTOL,
                              GOLDEN_TRAIN_SUM_TOL, golden_train_errors, golden_train_replay)
    from repro_torch.kernels import ops

    g = json.loads(GOLDEN_TRAIN.read_text())
    for name, case in g["cases"].items():
        # the pod case's channel is the SPMD codecs (plain torch): DP only
        kernels = ("sq_norm", "clip_noise") if case.get("pod") else (
            "int8_roundtrip", "sq_norm", "clip_noise")
        t0 = time.perf_counter()
        before = dict(ops.LAUNCHES)
        got = golden_train_replay(g, name, DEVICE)
        torch.cuda.synchronize()
        launched = {k: ops.LAUNCHES[k] - before[k] for k in kernels}
        loss, sums = golden_train_errors(case, got)
        check(loss <= GOLDEN_TRAIN_RTOL and sums <= GOLDEN_TRAIN_SUM_TOL,
              f"golden train {name}: loss rel err {loss} (tol {GOLDEN_TRAIN_RTOL}), checksum "
              f"err {sums} (tol {GOLDEN_TRAIN_SUM_TOL})")
        check(all(v > 0 for v in launched.values()), f"golden train {name}: a channel kernel "
                                                      f"never launched: {launched}")
        msg = ""
        if name in GOLDEN_TRAIN_FAULTED:
            f_loss, f_sums = golden_train_errors(
                case, golden_train_replay(g, name, DEVICE, uniform_weights=True))
            expect(f_loss > GOLDEN_TRAIN_RTOL and f_sums > GOLDEN_TRAIN_SUM_TOL,
                   f"golden train {name}: planted fault (sample counts ignored) not caught: "
                   f"{f_loss}, {f_sums}")
            msg = (f"; planted fault (sample counts ignored): loss {f_loss:.3e}, checksum "
                   f"{f_sums:.3e}")
        elif case.get("pod"):
            # 4 steps: the one sync moves the last two losses less than their gate
            _, f_sums = golden_train_errors(
                case, golden_train_replay(g, name, DEVICE, uniform_weights=True))
            expect(f_sums > GOLDEN_TRAIN_SUM_TOL, f"golden train {name}: planted fault (sample "
                                                  f"counts ignored) not caught: {f_sums}")
            msg = f"; planted fault (sample counts ignored): checksum {f_sums:.3e}"
        log(f"[golden-train] {name}: {len(got['losses'])} steps x 2 clouds, largest loss rel err "
            f"{loss:.3e} (tol {GOLDEN_TRAIN_RTOL:g}), checksum err {sums:.3e} (tol "
            f"{GOLDEN_TRAIN_SUM_TOL:g}){msg}; kernel launches {launched}; "
            f"{time.perf_counter() - t0:.2f} s")


# ------------------------------------------------------------ phases 5e, 5f
SPEC_K = 4


def _spec_engine(main, draft_params=None, num_slots=8, **kw):
    """An engine with phase 5's settings (8 slots, page 16, prefix cache) and,
    with ``draft_params``, a draft of the target's architecture proposing
    SPEC_K tokens per round."""
    from repro_torch.launch.engine import ServeEngine

    spec = {} if draft_params is None else dict(
        draft_model=main["model"], draft_params=draft_params, spec_tokens=SPEC_K)
    return ServeEngine(main["model"], main["params"], num_slots=num_slots, max_seq=384 + 32,
                       page_size=16, prefix_cache=True, paged_cache=True, device=DEVICE,
                       **spec, **kw)


def _run_trace(eng, main, sampling=None, order=1):
    """Phase 5's trace on ``eng`` from an empty prefix index and zeroed
    counters: the cold group, then the shared-prefix group once the first
    retired, each submitted in ``order`` (-1: reversed), request r sampled
    with ``sampling(r)`` (None: greedy). Returns ({uid: output}, wall s)."""
    import torch

    from repro_torch.launch.engine import Request

    if eng.prefix is not None:
        eng.prefix.clear()
    eng.reset_metrics()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = []
    for group in (main["cold"], main["hits"]):
        eng.reset_clock()
        outs += eng.run([Request(uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                                 sampling=None if sampling is None else sampling(r.uid))
                         for r in group[::order]])
    torch.cuda.synchronize()
    return {o.uid: o for o in outs}, time.perf_counter() - t0


def _agreement(a: dict, b: dict) -> str:
    """Token agreement of two traces, by uid: requests identical, and tokens
    equal up to each request's first difference."""
    same = sum(a[u] == b[u] for u in a)
    lead = 0
    for u in a:
        for x, y in zip(a[u], b[u]):
            if x != y:
                break
            lead += 1
    return (f"{same}/{len(a)} requests identical, {lead}/{sum(len(t) for t in a.values())} "
            "tokens before the first difference")


def _trace_line(label, smi, outs, wall, eng):
    tokens = sum(len(o.tokens) for o in outs.values())
    ps = eng.pool_stats
    ttft = float(np.percentile([o.ttft for o in outs.values()], 50))
    target = eng.steps + ps["cold_dispatches"] + ps["suffix_dispatches"]
    line = (f"{label} ({smi}): {len(outs)} requests, {tokens} tokens in {wall:.3f} s: "
            f"{tokens / wall:.1f} tok/s, TTFT p50 {ttft * 1e3:.1f} ms, "
            f"{target / tokens:.4f} target dispatches per token")
    if ps["spec_enabled"]:
        line += (f", {ps['spec_rounds']} spec rounds (k={ps['spec_tokens']}), acceptance "
                 f"{ps['spec_accept_rate']:.3f}, {ps['spec_dispatches_per_token']:.4f} verify "
                 "dispatches per round-emitted token")
    return line


def _verify_parity(main, store, label, faults):
    """The captured verify dispatch again from its cache, through the plain
    versions and through each planted fault: logits at every live position
    (the real vocabulary) within LOGIT_RTOL x scale of the kernels', the
    faults outside."""
    import torch

    model, params, cfg = main["model"], main["params"], main["model"].cfg
    a, kw = store["args"]
    lk = store["logits"]
    live = (torch.arange(lk.shape[1], device=DEVICE)[None, :] < a[1][:, None].long())
    vocab = cfg.vocab_size
    got = {}
    for fname, swap in [("plain", {}), *faults]:
        twin = {k: v.clone() for k, v in store["cache"].items()}
        with plain_kernels(**swap):
            _, lp = model.prefill_slots(params, twin, *a, **kw)
        got[fname] = lp[live][:, :vocab]
        del twin
    kl = lk[live][:, :vocab]
    tol = LOGIT_RTOL[cfg.dtype]
    scale = max(got["plain"].abs().max().item(), 1.0)
    d = (kl - got["plain"]).abs().max().item()
    agree = (kl.argmax(-1) == got["plain"].argmax(-1)).float().mean().item()
    starts = kw["starts"].tolist()
    msg = (f"[spec-main] {label}: one verify dispatch ({int(live.sum())} live positions of "
           f"{lk.shape[0]}x{lk.shape[1]}, starts {starts}, mid-page "
           f"{sum(st % 16 != 0 for st in starts)}): kernel vs plain max |dlogit| {d:.3e} = "
           f"{d / scale:.3e} x logit scale {scale:.2f} (tol {tol:g} x scale), argmax agreement "
           f"{agree:.3f}")
    expect(d <= tol * scale, f"spec {label}: verify logit diff {d} too large")
    for fname, _ in faults:
        fd = (kl - got[fname]).abs().max().item()
        msg += f"; planted fault '{fname}' {fd:.3e} = {fd / scale:.3e} x scale"
        expect(fd > tol * scale, f"spec {label}: planted fault '{fname}' within tolerance")
    log(msg)


def phase_spec_main(smi, main):
    """5e: phase 5's trace (stablelm-1.6b at full width, 16 requests x 32
    tokens, 8 slots, prefix cache) with k = 4 speculation: a same-params
    draft and a foreign-seed draft on fp pages, the same-params draft on
    int8 pages. Gates per run: every request's budget, finite logits, one
    verify dispatch's logits at every live position against the plain path
    (and a planted fault), no page left but the prefix index's, spec_emitted
    == generated - first tokens, and n_layers suffix_prefill launches per
    verify and suffix admission. Logged beside phase 5's plain trace: tok/s,
    TTFT p50, target dispatches per token, acceptance, token agreement.
    Returns the kernels' launches over the three runs, the same-params fp
    run's tokens and one full-vocabulary logit row."""
    import torch

    from repro_torch.kernels import ops

    model, cfg = main["model"], main["model"].cfg
    foreign = model.init(torch.Generator(device=DEVICE).manual_seed(1), DEVICE)
    log(f"[spec-main] phase 5's plain trace ({smi}): {main['tok_s']:.1f} tok/s, TTFT p50 "
        f"{main['ttft'] * 1e3:.1f} ms, {main['dispatches']:.4f} target dispatches per token")
    total: dict[str, int] = {}
    result = {}
    def run(draft, kv, graphs=True, store=None):
        eng = _spec_engine(main, draft, kv_dtype=kv, graphs=graphs)
        eng.warm(sorted({len(r.prompt) for r in main["cold"]}), gen_tokens=2)
        warmed = eng.compiles
        finite = []
        _tap(eng, finite, store)
        rounds = _round_timer(eng)
        ops.reset_launches()
        outs, wall = _run_trace(eng, main)
        eng.graphs.tap = None
        check(bool(torch.stack(finite).all()), f"spec {kv}: non-finite logits")
        # a speculative engine never runs the decode step (nor does the
        # reference's): its target only verifies
        check(eng.compiles["decode"] == 0
              and eng.compiles["prefill_slots"] == warmed["prefill_slots"],
              f"spec {kv}: specializations {warmed} after warm() -> {eng.compiles}")
        return eng, outs, wall, {k: c for k, c in ops.LAUNCHES.items() if c}, rounds

    for label, draft, kv in (("same-params draft, fp", main["params"], "fp"),
                             ("foreign draft (seed 1), fp", foreign, "fp"),
                             ("same-params draft, int8", main["params"], "int8")):
        t_phase = time.perf_counter()
        store = {}
        eng, outs, wall, launches, rounds = run(draft, kv, store=store)
        for k, c in launches.items():
            total[k] = total.get(k, 0) + c
        ps = eng.pool_stats
        toks = {u: o.tokens for u, o in outs.items()}
        n_tok = sum(len(t) for t in toks.values())
        verify = "suffix_prefill_int8" if kv == "int8" else "suffix_prefill"
        check(len(outs) == 16 and all(len(t) == 32 for t in toks.values()),
              f"spec {label}: not every request finished with 32 tokens")
        pinned = eng.prefix.size if eng.prefix is not None else 0
        check(eng.pool.in_use == pinned, f"spec {label}: {eng.pool.in_use} pages in use at the "
                                         f"end, the prefix index pins {pinned}")
        check(ps["spec_emitted"] == n_tok - len(outs),
              f"spec {label}: spec_emitted {ps['spec_emitted']} != {n_tok} - {len(outs)}")
        check(launches.get(verify, 0) == cfg.n_layers * (ps["spec_rounds"]
                                                         + ps["suffix_dispatches"])
              and ps["spec_rounds"] > 0,
              f"spec {label}: {launches.get(verify, 0)} {verify} launches for "
              f"{ps['spec_rounds']} rounds and {ps['suffix_dispatches']} suffix admissions")
        check(launches.get("paged_decode_ring", 0) > 0 and launches.get("flash_prefill", 0) > 0,
              f"spec {label}: the draft missed a kernel: {launches}")
        faults = [("last prefix key dropped", dict(suffix_prefill=_suffix_shift))]
        if kv == "int8":
            faults.append(("scale from the next slot", dict(suffix_prefill=_suffix_scale_slot)))
        _verify_parity(main, store, label, faults)
        log(f"[spec-main] {_trace_line(label, smi, outs, wall, eng)}; spec round wall p50 "
            f"{np.median(rounds) * 1e3:.2f} ms; against the plain fp trace: "
            f"{_agreement(toks, main['tokens'])}; launches {launches}; compiles "
            f"{eng.compiles}; graph pool {_pool_gb(eng)}; phase wall "
            f"{time.perf_counter() - t_phase:.1f} s")
        if label.startswith("same-params draft, fp"):
            result = dict(tokens=toks, row=store["logits"][0, 0].clone())
            graphed = _record(outs, wall, eng, launches, rounds)
            del eng
            gc.collect()
            # 5g: the same trace with every dispatch eager
            eng, e_outs, e_wall, e_launches, e_rounds = run(draft, kv, graphs=False)
            _twin_gate(label, smi, graphed, _record(e_outs, e_wall, eng, e_launches, e_rounds))
        del eng, store
        gc.collect()
        torch.cuda.empty_cache()
    del foreign
    gc.collect()
    torch.cuda.empty_cache()
    result["launches"] = total
    return result


SAMPLED = dict(temperature=0.8, top_k=40, top_p=0.95)
TV_DRAWS = 16384


def phase_sampling(smi, main, spec):
    """5f: phase 5's trace sampled (temperature 0.8, top-k 40, top-p 0.95;
    request r on seed 1000 + r) on the plain engine and with the same-params
    draft. Gates: a second run gives the same tokens; the requests submitted
    in reverse order (other slots, other neighbours) give the same tokens;
    in a trace where only even uids sample, the greedy odd uids keep their
    greedy trace's tokens. Logged: the plain trace over 4 slots (other batch
    widths: bf16 GEMMs of another shape may round otherwise). Then the
    batched sampler's law over TV_DRAWS draws of one full-vocabulary row
    from a verify dispatch: within 0.05 total variation of
    softmax(filter_logits(row))."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.sampling import SamplingParams, filter_logits, sample_rows

    base = SamplingParams(**SAMPLED)
    sp = lambda u: dataclasses.replace(base, seed=1000 + u)  # noqa: E731
    mixed = lambda u: sp(u) if u % 2 == 0 else None  # noqa: E731
    first = {}
    for label, eng, greedy in (("plain", main["engine"], main["tokens"]),
                               ("same-params draft", None, spec["tokens"])):
        t_phase = time.perf_counter()
        if eng is None:
            eng = _spec_engine(main, main["params"])
            eng.warm(sorted({len(r.prompt) for r in main["cold"]}), gen_tokens=2, sampling=base)
        runs = {}
        for name, fn, order in (("first", sp, 1), ("second", sp, 1), ("reversed", sp, -1),
                                ("mixed", mixed, 1)):
            ops.reset_launches()
            outs, wall = _run_trace(eng, main, fn, order)
            runs[name] = {u: o.tokens for u, o in outs.items()}
            if name == "first":
                slots = {u: o.slot for u, o in outs.items()}
                line = _trace_line(f"sampled, {label}", smi, outs, wall, eng)
                if label == "plain":
                    graphed = _record(outs, wall, eng, dict(ops.LAUNCHES))
            if name == "reversed":
                moved = sum(o.slot != slots[u] for u, o in outs.items())
            check(eng.pool.in_use == (eng.prefix.size if eng.prefix is not None else 0),
                  f"sampled {label} {name}: pages leaked")
        first[label] = runs["first"]
        check(runs["first"] == runs["second"], f"sampled {label}: a second run gave other tokens")
        check(runs["first"] == runs["reversed"],
              f"sampled {label}: the tokens depend on the slot or the neighbours")
        check(all(runs["mixed"][u] == greedy[u] for u in greedy if u % 2),
              f"sampled {label}: a greedy request's tokens moved beside sampled neighbours")
        check(runs["first"] != greedy, f"sampled {label}: the sampled trace is the greedy one")
        if label == "plain":
            # 5g: the first run again on phase 5's engine with every dispatch eager
            ops.reset_launches()
            outs, wall = _run_trace(main["eager"], main, sp)
            _twin_gate("sampled, plain", smi, graphed,
                       _record(outs, wall, main["eager"], dict(ops.LAUNCHES)))
        log(f"[sampled] {line}; a second run identical, reversed submission identical "
            f"({moved}/16 requests in another slot), greedy odd uids beside sampled even ones "
            f"identical to the greedy trace; against the greedy trace: "
            f"{_agreement(runs['first'], greedy)}; phase wall "
            f"{time.perf_counter() - t_phase:.1f} s")
        if eng is not main["engine"]:
            del eng
            gc.collect()
            torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    eng4 = _spec_engine(main, num_slots=4)
    eng4.warm(sorted({len(r.prompt) for r in main["cold"]}), gen_tokens=2, sampling=base)
    outs, wall = _run_trace(eng4, main, sp)
    toks4 = {u: o.tokens for u, o in outs.items()}
    log(f"[sampled] {_trace_line('sampled, plain, 4 slots', smi, outs, wall, eng4)}; against "
        f"8 slots (not gated): {_agreement(toks4, first['plain'])}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    del eng4
    gc.collect()
    torch.cuda.empty_cache()
    # the sampler's law on one full-vocabulary row
    row = spec["row"]
    vocab = main["model"].cfg.vocab_size
    stream = np.random.Generator(np.random.Philox(np.random.SeedSequence(77)))
    counts = torch.zeros(vocab, dtype=torch.float64, device=DEVICE)
    chunk = 1024
    for _ in range(TV_DRAWS // chunk):
        u = torch.from_numpy(stream.random(chunk)).to(DEVICE)
        toks = sample_rows(row.expand(chunk, -1), u, base.temperature, base.top_k, base.top_p,
                           vocab)
        counts += torch.bincount(toks, minlength=vocab).double()
    p = torch.softmax(filter_logits(row[None], base.temperature, base.top_k, base.top_p,
                                    vocab), -1)[0].double()
    tv = 0.5 * (counts / TV_DRAWS - p).abs().sum().item()
    support = int((p > 0).sum())
    expect(tv <= 0.05, f"sampler law: total variation {tv} > 0.05")
    check(bool((p[counts > 0] > 0).all()), "the sampler drew a token the filter removed")
    log(f"[sampled] batched sampler, {TV_DRAWS} draws of one verify logit row (vocab {vocab}, "
        f"{support} tokens kept by the filter): total variation {tv:.4f} from "
        f"softmax(filter_logits(row)) (tol 0.05)")


# ------------------------------------------------------------- phases 5i, 5j
ROUTER_STAGGER = 0.02
# (label, fault spec, replicas with host tiers, sampled)
ROUTER_RUNS = (("fault-free", None, True, False), ("kill", "kill:1@8", True, False),
               ("stall", "stall:1@8", True, False), ("slow", "slow:1@4@0.05", True, False),
               ("sampled fault-free", None, True, True), ("sampled kill", "kill:1@8", True, True),
               ("kill, recompute", "kill:1@8", False, False))


def _router_engine_kw(host_pages):
    """Phase 5's engine (8 slots, page 16, prefix cache) with a host tier."""
    return dict(num_slots=8, max_seq=384 + 32, page_size=16, prefix_cache=True, paged_cache=True,
                host_pages=host_pages, device=DEVICE)


def _watch_router(engines) -> tuple[dict, dict]:
    """Instrument ``engines`` for one router run: how each migrated request
    resumed (``moves``: "carried" when its importer adopted its pages,
    "recompute" when it re-prefills its history, "fresh" when it had emitted
    nothing) and the shape of every admission round each request went
    through (``rounds``: cold or suffix, bucket width and length, prefix-page
    width)."""
    from repro_torch.launch.engine import bucket_length, bucket_pages, bucket_width

    moves, rounds = {}, {}
    for e in engines:
        def imported(items, e=e, fn=e.import_inflight):
            fn(items)
            for req, res in items:
                moves[req.uid] = ("fresh" if res is None or not res.generated else
                                  "carried" if res.host_key is not None else "recompute")

        def prefill(claimed, e=e, fn=e._prefill_claimed):
            for hit in (False, True):
                group = [i for i in claimed if (e.slots[i].prefix_len > 0) == hit]
                if not group:
                    continue
                lens = [len(e.slots[i].feed) - e.slots[i].prefix_len for i in group]
                pw = bucket_pages(-(-max(e.slots[i].prefix_len for i in group) // e.page_size),
                                  e.table_width) if hit else 0
                for i in group:
                    rounds.setdefault(e.slots[i].req.uid, []).append(
                        ("suffix" if hit else "cold", bucket_width(len(group), e.num_slots),
                         bucket_length(max(lens)), pw))
            return fn(claimed)

        e.import_inflight = imported
        e._prefill_claimed = prefill
    return moves, rounds


def _router_run(engines, reqs, fault, sampling, smi, label):
    """One real-time router run over warmed ``engines``: arrivals
    ROUTER_STAGGER apart from the clock's restart at ``warm``. Returns the
    run's record, and logs its throughput, TTFT and latency p50 from
    arrival, router counters, compiles and graph pools, the first-use
    captures inside the trace and the kernels' launches."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.engine import Request
    from repro_torch.launch.router import ServeRouter, parse_fault_spec

    router = ServeRouter(engines=engines, fault_plan=parse_fault_spec([fault]) if fault else None,
                         stall_patience=3)
    lens = sorted({len(r.prompt) for r in reqs})
    router.warm(lens, gen_tokens=2, sampling=sampling(0) if sampling else None)
    moves, rounds = _watch_router(engines)
    compiles = [e.graphs.graphs for e in engines]
    ops.reset_launches()
    t0 = time.perf_counter()
    outs = router.run([Request(uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                               arrival_time=j * ROUTER_STAGGER,
                               sampling=sampling(r.uid) if sampling else None)
                       for j, r in enumerate(reqs)], realtime=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for e in engines:  # drop the instruments
        del e.import_inflight, e._prefill_claimed
    launches = {k: c for k, c in ops.LAUNCHES.items() if c}
    rs = router.router_stats
    tokens = sum(len(o.tokens) for o in outs)
    ttft = float(np.percentile([o.ttft for o in outs], 50))
    lat = float(np.percentile([o.latency for o in outs], 50))
    captures = [e.graphs.graphs - c for e, c in zip(engines, compiles)]
    log(f"[router-main] {label} ({smi}): {len(outs)} requests, {tokens} tokens in {wall:.3f} s: "
        f"{tokens / wall:.1f} tok/s, TTFT p50 {ttft * 1e3:.1f} ms, latency p50 {lat * 1e3:.1f} ms "
        f"(both from arrival); first-use captures inside the trace per replica {captures}")
    log(f"[router-main] {label}: router_stats {rs}; moves {moves}")
    log(f"[router-main] {label}: per replica compiles {[e.compiles for e in engines]}, graph "
        f"pools {[_pool_gb(e) for e in engines]}; kernel launches {launches}")
    return dict(outs={o.uid: o for o in outs}, stats=rs, moves=moves, rounds=rounds,
                shed=router.shed_errors, launches=launches, tok_s=tokens / wall, ttft=ttft,
                lat=lat)


def _router_suite(model, params, reqs, smi, tag, gate_recompute):
    """The runs of ROUTER_RUNS over 2 replicas of ``model`` sharing
    ``params``. Gates: every request finishes with 32 tokens and none is
    shed; the kill and stall runs record one migration with at least one
    migrated request; each faulted run's tokens equal its fault-free run's
    for every request that kept its pages, carried them or moved before its
    first token, and with ``gate_recompute`` (float32) also for those that
    re-prefilled their history (in bf16 the prefill's K/V are not the decode
    step's: reported by ``_agreement``). Requests whose admission rounds had
    other shapes than in the fault-free run are gated like the rest and
    counted apart, with the shapes, for the log. Returns the runs'
    records."""
    import torch

    from repro_torch.launch.router import ServeRouter
    from repro_torch.launch.sampling import SamplingParams

    pairs = {}
    runs = {}
    for label, fault, tier, sampled in ROUTER_RUNS:
        if tier not in pairs:  # the runs of one pair of replicas come together
            pairs.clear()
            gc.collect()
            torch.cuda.empty_cache()
            pairs[tier] = ServeRouter(model, params, replicas=2,
                                      **_router_engine_kw(256 if tier else 0)).engines
        sp = (lambda u: SamplingParams(**SAMPLED, seed=1000 + u)) if sampled else None
        r = _router_run(pairs[tier], reqs, fault, sp, smi, f"{tag}, {label}")
        runs[label] = r
        check(len(r["outs"]) == len(reqs) and all(len(o.tokens) == 32 for o in r["outs"].values()),
              f"router {tag} {label}: not every request finished with 32 tokens")
        check(not r["shed"], f"router {tag} {label}: requests shed: {r['shed']}")
        if fault and not fault.startswith("slow"):
            check(r["stats"]["migrations"] == 1 and r["stats"]["migrated_requests"] >= 1,
                  f"router {tag} {label}: no migration recorded: {r['stats']}")
        else:
            check(r["stats"]["migrations"] == 0, f"router {tag} {label}: a migration")
    sub = lambda d, us: {u: d[u] for u in sorted(us)}  # noqa: E731
    for label, fault, tier, sampled in ROUTER_RUNS:
        if fault is None:
            continue
        base = runs["sampled fault-free" if sampled else "fault-free"]
        r = runs[label]
        toks = {u: o.tokens for u, o in r["outs"].items()}
        want = {u: o.tokens for u, o in base["outs"].items()}
        recompute = {u for u, m in r["moves"].items() if m == "recompute"}
        gated = [u for u in toks if gate_recompute or u not in recompute]
        reshaped = {u for u in gated if r["rounds"].get(u) != base["rounds"].get(u)}
        bad = [u for u in gated if toks[u] != want[u]]
        check(not bad, f"router {tag} {label}: tokens differ from the fault-free run for "
                       f"requests {bad} (moves {r['moves']}, rounds "
                       f"{[r['rounds'].get(u) for u in bad]} vs "
                       f"{[base['rounds'].get(u) for u in bad]})")
        log(f"[router-main] {tag}, {label} against its fault-free run: {len(gated)} of "
            f"{len(toks)} requests gated, identical ({len(reshaped)} of them admitted in rounds "
            f"of other shapes than in the fault-free run); {len(recompute)} re-prefilled their "
            "history"
            + (f" (not gated): {_agreement(sub(toks, recompute), sub(want, recompute))}"
               if recompute and not gate_recompute else ""))
    del pairs
    gc.collect()
    torch.cuda.empty_cache()
    return runs


def phase_router_main(smi, main):
    """5i: phase 5's trace (8 cold prompts of 96-384 tokens, then 8 on a
    shared 256-token prefix, 32 tokens each) arriving ROUTER_STAGGER apart,
    served in real time by ``ServeRouter`` over 2 replicas of phase 5's
    engine with host tiers of 256 pages, at stablelm-1.6b's published widths
    (bf16), sharing one params dict: fault-free, kill:1@8, stall:1@8
    (patience 3), slow:1@4@0.05, kill:1@8 with ``host_pages=0`` (every
    migrated request re-prefills), and a sampled pair (fault-free,
    kill:1@8). Gates: ``_router_suite``'s (in bf16 the re-prefilled
    requests are reported, not gated), and device memory growing by less
    than one params' size from one replica to two. The same runs again at
    the smoke config in float32, where every request is gated, the
    re-prefilled ones too."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.router import ServeRouter
    from repro_torch.models.model import build_model

    model, params = main["model"], main["params"]
    reqs = main["cold"] + main["hits"]
    p_bytes = _nbytes(params)
    gc.collect()
    torch.cuda.empty_cache()
    m0 = torch.cuda.memory_allocated()
    one = ServeRouter(model, params, replicas=1, **_router_engine_kw(256))
    m1 = torch.cuda.memory_allocated()
    del one
    gc.collect()
    torch.cuda.empty_cache()
    two = ServeRouter(model, params, replicas=2, **_router_engine_kw(256))
    m2 = torch.cuda.memory_allocated()
    del two
    gc.collect()
    torch.cuda.empty_cache()
    check(m2 - m1 < p_bytes, f"router: a second replica took {(m2 - m1) / 1e9:.3f} GB, not less "
                             f"than the params' {p_bytes / 1e9:.3f} GB (weights copied?)")
    log(f"[router-main] device memory: one replica +{(m1 - m0) / 1e9:.3f} GB, two +"
        f"{(m2 - m0) / 1e9:.3f} GB (the second {(m2 - m1) / 1e9:.3f} GB < params "
        f"{p_bytes / 1e9:.3f} GB: shared weights)")
    t0 = time.perf_counter()
    runs = _router_suite(model, params, reqs, smi, "bf16", gate_recompute=False)
    log(f"[router-main] bf16 runs wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(get_smoke_config("stablelm-1.6b"), dtype="float32")
    model32 = build_model(cfg32)
    params32 = model32.init(torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
    cold32, hits32 = _main_path_requests(cfg32.vocab_size)
    _router_suite(model32, params32, cold32 + hits32, smi, "fp32 smoke", gate_recompute=True)
    log(f"[router-main] fp32 smoke runs wall {time.perf_counter() - t0:.1f} s")
    return runs


def phase_lifecycle(smi, main):
    """5j: the request lifecycle on one engine at stablelm-1.6b's published
    widths (bf16), on a virtual clock advanced once per step. Gates: (a) a
    pool that runs dry preempts the old priority -1 request, not the
    youngest (which it does at priority 0); (b) a swapped mid-prefill victim
    (interleaved) queued past its deadline is shed with "deadline_exceeded"
    and its host-tier entry released; (c) ``max_wall_s`` retires a live slot
    with "timeout" and the prefix index holds none of its pages (without the
    watchdog the same request publishes them); (d) ``export_inflight`` of
    4 mid-decode requests (2 greedy, 2 sampled) and ``import_inflight`` into
    a second engine with a host tier: the pages are carried and swapped in,
    and every token is the uninterrupted run's; (e) ``prefix_probe`` leaves
    the hit rate, the LRU order and every refcount as they were."""
    import torch

    from repro_torch.launch.engine import Request, ServeEngine
    from repro_torch.launch.sampling import SamplingParams

    model, params = main["model"], main["params"]
    vocab = model.cfg.vocab_size
    rng = np.random.default_rng(23)
    clock = [0.0]
    kw = dict(page_size=16, paged_cache=True, device=DEVICE, time_fn=lambda: clock[0])

    def prompt(n):
        return rng.integers(0, vocab, n, dtype=np.int32)

    def drive(eng, reqs=(), until=None):
        for r in reqs:
            eng.submit(r)
        outs = []
        while eng.has_work and not (until is not None and until(eng)):
            outs += eng.step()
            clock[0] += 1.0
        return {o.uid: o for o in outs}

    # (a) priorities on a pool that runs dry 12 tokens into decoding
    eng = ServeEngine(model, params, num_slots=2, max_seq=176, num_pages=16, host_pages=64, **kw)
    pair = [prompt(100), prompt(100)]
    victims = {}
    for prio in ((-1, 0), (0, 0)):
        eng.reset_metrics()
        outs = drive(eng, [Request(uid=u, prompt=pair[u], max_new_tokens=64, priority=prio[u])
                           for u in (0, 1)])
        check(len(outs) == 2 and all(len(o.tokens) == 64 for o in outs.values()),
              f"lifecycle (a) {prio}: not every request finished")
        check(eng.preemptions > 0, f"lifecycle (a) {prio}: the pool never ran dry")
        victims[prio] = [u for u in (0, 1) if len(eng.slot_history[u]) > 1]
        victims[prio, "tokens"] = {u: o.tokens for u, o in outs.items()}
    check(victims[(-1, 0)] == [0], f"lifecycle (a): priorities (-1, 0) preempted {victims[(-1, 0)]}"
                                   ", not the old low-priority request 0")
    check(victims[(0, 0)] == [1], f"lifecycle (a): equal priorities preempted {victims[(0, 0)]}, "
                                  "not the youngest request 1")
    log(f"[lifecycle] (a) {smi}: a 15-page pool, 2 requests of 100 + 64 tokens: priorities (-1, 0)"
        f" preempt request 0 (the older), (0, 0) request 1 (the youngest); swapped back, tokens "
        f"of the two runs: {_agreement(victims[(-1, 0), 'tokens'], victims[(0, 0), 'tokens'])}")
    del eng

    # (b) a swapped mid-prefill victim past its deadline
    eng = ServeEngine(model, params, num_slots=2, max_seq=128, num_pages=7, host_pages=64,
                      prefill="interleaved", **kw)
    swapped = lambda e: any(not r.generated and r.host_key is not None  # noqa: E731
                            for r in e._resume.values())
    drive(eng, [Request(uid=u, prompt=prompt(60), max_new_tokens=2) for u in (0, 1)],
          until=swapped)
    check(swapped(eng), "lifecycle (b): no mid-prefill victim was swapped out")
    victim = next(u for u, r in eng._resume.items() if r.host_key is not None)
    held = eng.host.pages
    for r in eng.waiting:
        if r.uid == victim:
            r.deadline_s = 1e-9
    outs = drive(eng)
    check([(e.uid, e.reason) for e in eng.shed] == [(victim, "deadline_exceeded")],
          f"lifecycle (b): shed {[(e.uid, e.reason) for e in eng.shed]}")
    check(eng.host.pages == 0 and victim not in eng._resume and victim not in outs,
          f"lifecycle (b): the shed request's tier entry stayed ({eng.host.pages} pages)")
    log(f"[lifecycle] (b) {smi}: interleaved, a 6-page pool: request {victim} swapped out "
        f"mid-prompt ({held} tier pages), its deadline passed in the queue: shed with "
        f"deadline_exceeded, tier back to {eng.host.pages} pages; request "
        f"{sorted(outs)} served")
    del eng

    # (c) the watchdog, then (e) the probe on the index the control run fills
    eng = ServeEngine(model, params, num_slots=2, max_seq=416, prefix_cache=True, max_wall_s=5.0,
                      **kw)
    req = prompt(96)
    out = drive(eng, [Request(uid=0, prompt=req, max_new_tokens=32)])[0]
    check(out.finish_reason == "timeout" and eng.timeouts == 1 and 0 < len(out.tokens) < 32,
          f"lifecycle (c): {out.finish_reason}, {len(out.tokens)} tokens, {eng.timeouts} timeouts")
    check(eng.prefix.size == 0 and eng.prefix_probe(req) == 0 and eng.pool.in_use == 0,
          f"lifecycle (c): the timed-out slot's pages reached the prefix index "
          f"({eng.prefix.size} pages)")
    eng.max_wall_s = 0.0
    full = drive(eng, [Request(uid=1, prompt=req, max_new_tokens=32)])[1]
    check(full.finish_reason == "length" and full.tokens[:len(out.tokens)] == out.tokens
          and eng.prefix.size == 6, f"lifecycle (c): control run {full.finish_reason}, index "
                                    f"{eng.prefix.size} pages")
    log(f"[lifecycle] (c) {smi}: max_wall_s 5 steps retired the slot after {len(out.tokens)} "
        f"tokens with 'timeout', index 0 pages; without the watchdog the same request ran to "
        f"32 tokens (the same first {len(out.tokens)}) and published 6 pages")
    leaves = lambda: sorted((n.last_used, n.page) for n in eng.prefix._leaves())  # noqa: E731
    snap = lambda: (eng.pool_stats["prefix_hit_rate"], eng.prefix.lookups,  # noqa: E731
                    eng.prefix.hit_pages, [eng.pool.refcount(p) for p in range(eng.num_pages)],
                    leaves())
    before = snap()
    hits = [eng.prefix_probe(req), eng.prefix_probe(req[:40]), eng.prefix_probe(prompt(96))]
    check(hits == [96, 32, 0] and snap() == before,
          f"lifecycle (e): probes {hits}, state changed: {snap() != before}")
    log(f"[lifecycle] (e) {smi}: prefix_probe {hits} tokens; hit rate, lookups, hit pages, "
        f"every refcount and the LRU order unchanged")
    del eng

    # (d) export mid-decode, import with carried pages
    sp = SamplingParams(**SAMPLED)
    four = [prompt(n) for n in (96, 150, 200, 120)]
    reqs = lambda: [Request(uid=u, prompt=p, max_new_tokens=32,  # noqa: E731
                            sampling=dataclasses.replace(sp, seed=2000 + u) if u >= 2 else None)
                    for u, p in enumerate(four)]
    src = ServeEngine(model, params, num_slots=4, max_seq=416, prefix_cache=True, host_pages=256,
                      **kw)
    whole = {u: o.tokens for u, o in drive(src, reqs()).items()}
    src.prefix.clear()
    src.reset_metrics()
    for r in reqs():
        src.submit(r)
    early = {}
    for _ in range(6):
        early.update({o.uid: o for o in src.step()})
        clock[0] += 1.0
    items = src.export_inflight()
    carried = sum(res is not None and res.host_arrays is not None for _, res in items)
    check(carried == 4 and not src.has_work and src.pool.in_use == 0,
          f"lifecycle (d): {carried} of {len(items)} exported requests carry pages")
    dst = ServeEngine(model, params, num_slots=4, max_seq=416, prefix_cache=True, host_pages=256,
                      **kw)
    dst.import_inflight(items)
    adopted = sum(res.host_key is not None for _, res in items)
    merged = {u: o.tokens for u, o in {**early, **drive(dst)}.items()}
    check(adopted == 4 and dst.swapped_in_pages > 0 and dst.prefill_tokens == 0,
          f"lifecycle (d): {adopted} adopted, {dst.swapped_in_pages} pages swapped in, "
          f"{dst.prefill_tokens} prefill tokens")
    check(merged == whole, f"lifecycle (d): migrated tokens differ: {_agreement(merged, whole)}")
    log(f"[lifecycle] (d) {smi}: 4 requests (2 greedy, 2 sampled) exported after 6 steps with "
        f"their pages, adopted and swapped in ({dst.swapped_in_pages} pages, no prefill) by a "
        f"second engine: every token the uninterrupted run's ({_agreement(merged, whole)})")
    del src, dst
    gc.collect()
    torch.cuda.empty_cache()


def phase_eos(smi, main):
    """EOS at full width: phase 5's cold group on its engine with ``eos_id``
    set to a token the greedy trace emits (uid 3's sixth). Every request
    must end at its first EOS with ``finish_reason`` "eos", or at its budget
    with "length", with the greedy trace's tokens up to there."""
    eng = main["engine"]
    greedy = main["tokens"]
    eos = greedy[3][5]
    eng.eos_id = eos
    try:
        if eng.prefix is not None:
            eng.prefix.clear()
        eng.reset_metrics()
        outs = {o.uid: o for o in eng.run(main["cold"])}
    finally:
        eng.eos_id = None
    for u, o in outs.items():
        full = greedy[u]
        cut = full.index(eos) + 1 if eos in full else len(full)
        check(o.tokens == full[:cut], f"eos: uid {u} tokens {o.tokens} != {full[:cut]}")
        check(o.finish_reason == ("eos" if eos in full else "length"),
              f"eos: uid {u} finish_reason {o.finish_reason}")
    ended = {u: len(o.tokens) for u, o in outs.items() if o.finish_reason == "eos"}
    check(3 in ended, "eos: uid 3 did not end at its EOS")
    log(f"[eos] ({smi}): eos_id {eos}: requests ended at EOS (uid: tokens) {ended}, the other "
        f"{len(outs) - len(ended)} at their 32-token budget, every token the greedy trace's")


# ----------------------------------------------------------------- phase 5b
def _int8_path_requests(vocab):
    """8 cold prompts of 256-384 tokens (64 greedy tokens each; the first
    holds the shared 256-token prefix, which its retirement publishes), then
    8 prompts of that prefix plus 32-64 tokens (32 greedy tokens each)."""
    from repro_torch.launch.engine import Request

    rng = np.random.default_rng(11)
    prefix = rng.integers(0, vocab, 256, dtype=np.int32)
    cold = []
    for u, n in enumerate(rng.integers(256, 385, 8)):
        p = rng.integers(0, vocab, int(n), dtype=np.int32)
        if u == 0:
            p[:256] = prefix
        cold.append(Request(uid=u, prompt=p, max_new_tokens=64))
    hits = [Request(uid=8 + j, max_new_tokens=32, prompt=np.concatenate(
        [prefix, rng.integers(0, vocab, int(rng.integers(32, 65)), dtype=np.int32)]))
        for j in range(8)]
    return cold, hits


def _serve_trace(model, params, cold, hits, smi, label, tag="int8-main", **engine_kw):
    """One engine over the trace (cold group, then the shared-prefix group
    once the first retired): tokens, pool stats, launches, the engine and
    the trace's record for ``_twin_gate``. Gates finite logits, one decode
    specialization and no new prefill_slots one after ``warm()``; logs
    under ``tag``."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.engine import Request, ServeEngine

    eng = ServeEngine(model, params, num_slots=8, max_seq=384 + 64, page_size=16,
                      prefix_cache=True, paged_cache=True, device=DEVICE, **engine_kw)
    eng.warm(sorted({len(r.prompt) for r in cold}), gen_tokens=2)
    warmed = eng.compiles
    finite = []
    _tap(eng, finite)
    # host wall of the tier's copies (each synchronous): device->host
    # gathers (swap-out, demotion) and host->device restores (swap-in,
    # promotion)
    io = {"_gather_host": [0, 0.0], "_restore_pages": [0, 0.0]}
    for name in io:
        def timed(*a, _fn=getattr(eng, name), _acc=io[name]):
            t = time.perf_counter()
            out = _fn(*a)
            _acc[0] += 1
            _acc[1] += time.perf_counter() - t
            return out
        setattr(eng, name, timed)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    outs = []
    for group in (cold, hits):
        eng.reset_clock()
        outs += eng.run([Request(uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens)
                         for r in group])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    eng.graphs.tap = None
    check(bool(torch.stack(finite).all()), f"{label}: non-finite logits")
    check(eng.compiles["decode"] == 1 and eng.compiles["prefill_slots"] == warmed["prefill_slots"],
          f"{label}: specializations {warmed} after warm() -> {eng.compiles}")
    ps = dict(eng.pool_stats, prefix_hit_tokens=eng.prefix_hit_tokens)
    tokens = sum(len(o.tokens) for o in outs)
    ttft = float(np.percentile([o.ttft for o in outs], 50))
    lat = float(np.percentile([o.latency for o in outs], 50))
    log(f"[{tag}] {label} ({smi}): {len(outs)} requests, {tokens} tokens in {wall:.3f} s: "
        f"{tokens / wall:.1f} tok/s, TTFT p50 {ttft * 1e3:.1f} ms, latency p50 "
        f"{lat * 1e3:.1f} ms; {eng.steps} decode steps, {ps['cold_dispatches']} cold + "
        f"{ps['suffix_dispatches']} suffix dispatches; {ps['allocatable_pages']} pages, "
        f"{ps['preemptions']} preemptions, swapped out/in {ps['swapped_out_pages']}/"
        f"{ps['swapped_in_pages']} pages, host demoted/promoted {ps['host_demoted_pages']}/"
        f"{ps['host_promote_hits']}, prefill tokens {ps['prefill_tokens']} (lookup "
        f"{ps['prefix_lookup_tokens']}, hit {ps['prefix_hit_tokens']}), {ps['cow_copies']} CoW"
        + (f"; host tier copies: {io['_gather_host'][0]} device->host gathers "
           f"{io['_gather_host'][1] * 1e3:.1f} ms, {io['_restore_pages'][0]} host->device "
           f"restores {io['_restore_pages'][1] * 1e3:.1f} ms (host wall)"
           if eng.host is not None else "") + f"; compiles {eng.compiles}")
    return {o.uid: o.tokens for o in outs}, ps, launches, eng, _record(outs, wall, eng, launches)


def phase_main_path_int8(smi):
    """stablelm-1.6b at its published widths over an int8 pool with a host
    tier: a pool tight enough that cold slots are preempted, swapped out and
    swapped back in without a prefill; then prefix hits. Gates: every
    request completes, swapped in == out > 0, no swapped slot prefilled
    again, more prefill without the tier, the swap entries drain, every
    int8 kernel launched, kernel-vs-plain logits on an int8 cache. Printed
    without a gate: the ample int8 and the fp pool on the same trace."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    cfg = get_config("stablelm-1.6b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
    cold, hits = _int8_path_requests(cfg.vocab_size)
    _logit_parity(model, params, cfg, cold, hits, kv_dtype="int8")
    torch.cuda.empty_cache()

    page = 16
    prompt_pages = sum(-(-len(r.prompt) // page) for r in cold)
    # all 8 cold prompts fit at admission; their 64 decode tokens need ~32
    # more pages than the 4 spare ones, so the youngest slots are preempted
    num_pages = prompt_pages + 4 + 1
    host_pages = 256
    want = {r.uid: r.max_new_tokens for r in cold + hits}
    toks, ps, launches, eng, graphed = _serve_trace(
        model, params, cold, hits, smi, f"int8, {num_pages - 1} pages, host tier {host_pages}",
        kv_dtype="int8", num_pages=num_pages, host_pages=host_pages)
    check(all(len(toks[u]) == n for u, n in want.items()),
          "not every request completed its budget")
    check(ps["preemptions"] >= 2, f"fewer than two preemptions: {ps['preemptions']}")
    check(ps["swapped_in_pages"] == ps["swapped_out_pages"] > 0,
          f"swapped in {ps['swapped_in_pages']} != out {ps['swapped_out_pages']} (or none)")
    check(ps["prefill_tokens"] == ps["prefix_lookup_tokens"] - ps["prefix_hit_tokens"],
          f"a swapped slot was prefilled again: {ps}")
    check(all(key[0] == "prefix" for key in eng.host.keys()),
          f"swap entries left on the host tier: {eng.host.keys()}")
    check(ps["suffix_dispatches"] > 0 and ps["cold_dispatches"] > 0,
          f"dispatch split not exercised: {ps}")
    check(all(launches[k] > 0 for k in SERVING_INT8), f"an int8 kernel never launched: "
                                                      f"{launches}")
    check(launches["int8_encode"] == 0, f"the flat encoder ran on the int8 trace: {launches}")
    per_step = _profile_decode(eng, smi, label="profile int8")
    check(per_step.get("kv_write_int8") == cfg.n_layers and "int8_encode" not in per_step,
          f"an int8 decode step must write the pool once per layer ({cfg.n_layers}) through "
          f"kv_write_int8 and never launch int8_encode: {per_step}")
    int8_launches = {k: launches[k] for k in (*SERVING_INT8, "int8_encode")
                     if k != "flash_prefill"}
    # the tier's hooks make a reference cycle (engine -> prefix index ->
    # engine): collect it, or its pool and parameters outlive the phase
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    # 5g: the same trace with every dispatch eager
    *_, eng, eager = _serve_trace(model, params, cold, hits, smi,
                                  f"int8, {num_pages - 1} pages, host tier {host_pages}, eager",
                                  kv_dtype="int8", num_pages=num_pages, host_pages=host_pages,
                                  graphs=False)
    _twin_gate("int8 pages + host tier", smi, graphed, eager)
    _profile_decode(eng, smi, label="profile int8")
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    _, ps_rc, _, eng, _ = _serve_trace(model, params, cold, hits, smi,
                                    f"int8, {num_pages - 1} pages, no host tier",
                                    kv_dtype="int8", num_pages=num_pages)
    check(ps_rc["prefill_tokens"] > ps["prefill_tokens"],
          f"without the tier the trace prefilled no more: {ps_rc['prefill_tokens']} vs "
          f"{ps['prefill_tokens']}")
    del eng
    # a second tier / no-tier pair, alternating with the first, now that the
    # pinned host allocator is warm: the tier's cost read within one call
    for label, kw in (("host tier", dict(host_pages=host_pages)), ("no host tier", {})):
        _, _, _, eng, _ = _serve_trace(model, params, cold, hits, smi,
                                    f"int8, {num_pages - 1} pages, {label}, second run",
                                    kv_dtype="int8", num_pages=num_pages, **kw)
        del eng
        gc.collect()
    ample, ps_a, _, eng, _ = _serve_trace(model, params, cold, hits, smi, "int8, ample pool",
                                       kv_dtype="int8")
    del eng
    fp, ps_fp, _, eng, _ = _serve_trace(model, params, cold, hits, smi, "fp, ample pool")
    pages_fp = ps_fp["num_pages"]
    del eng
    torch.cuda.empty_cache()

    def match(a, b):
        return sum(a[u] == b[u] for u in a) / len(a)

    L, hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    fp_bytes = 2 * L * hkv * hd * 2              # k and v, bf16
    int8_bytes = 2 * L * hkv * (hd + 4)          # k and v int8 plus f32 scales
    seq = np.mean([len(r.prompt) + r.max_new_tokens for r in cold + hits])
    budget = pages_fp * page * fp_bytes
    log(f"[int8-main] tokens: tight int8 + host tier vs ample int8 match {match(toks, ample):.3f}"
        f" of requests; ample int8 vs fp {match(ample, fp):.3f}. Pool bytes per token: fp "
        f"{fp_bytes}, int8 with scales {int8_bytes} ({fp_bytes / int8_bytes:.3f}x); at the fp "
        f"pool's {budget / 1e9:.3f} GB ({pages_fp} pages) {budget / (fp_bytes * seq):.1f} "
        f"resident sequences of the trace's mean {seq:.0f} tokens in fp, "
        f"{budget / (int8_bytes * seq):.1f} in int8")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return int8_launches


# ----------------------------------------------------------------- phase 4c
RING_GOLDEN_KERNELS = ("paged_decode_ring", "swa_decode", "flash_prefill", "paged_decode")


def phase_golden_ring():
    """The reference's float32 ring-mode trace: the ring engine (chunked
    with a window the prompts wrap, interleaved, paged decode off), the
    windowed paged engine and the windowed single-batch path; every token
    must be the reference's."""
    import torch

    from repro_torch.bridge import numpy_params, params_from_numpy
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import Request, ServeEngine
    from repro_torch.launch.serve import generate_batch
    from repro_torch.models.model import build_model

    g = json.loads((ROOT / "src/repro_torch/testdata/golden_stablelm_smoke_ring.json")
                   .read_text())
    cfg = dataclasses.replace(get_smoke_config("stablelm-1.6b"), dtype="float32")
    model = build_model(cfg)
    params = params_from_numpy(numpy_params(cfg, g["seed"]), cfg, DEVICE)
    before = dict(ops.LAUNCHES)
    for run in g["runs"]:
        eng = ServeEngine(model, params, device=DEVICE, **run["engine"])
        outs = eng.run([Request(uid=u, prompt=p, max_new_tokens=g["max_new_tokens"])
                        for u, p in enumerate(g["prompts"])])
        got = [o.tokens for o in outs]
        check(got == run["tokens"], f"golden ring run {run['name']}: tokens differ from the "
                                    f"reference:\n{got}\n{run['tokens']}")
    sb = g["serve_batch"]
    gen, _, _ = generate_batch(model, params, torch.tensor(g["prompts"], device=DEVICE),
                               g["max_new_tokens"], window=sb["window"])
    check(gen.tolist() == sb["tokens"], f"golden serve_batch tokens differ from the "
                                        f"reference:\n{gen.tolist()}\n{sb['tokens']}")
    torch.cuda.synchronize()
    launched = {k: ops.LAUNCHES[k] - before[k] for k in RING_GOLDEN_KERNELS}
    check(all(v > 0 for v in launched.values()), f"golden ring runs missed a kernel: "
                                                 f"{launched}")
    log(f"[golden-ring] {len(g['runs'])} engine runs ({', '.join(r['name'] for r in g['runs'])})"
        f" and serve_batch window {sb['window']}: fp32 greedy tokens identical to the "
        f"reference's; kernel launches {launched}")


# ----------------------------------------------------------------- phase 5c
RING_PROMPTS = (6144, 5000, 2048, 700, 300, 96)
RING_WINDOW, RING_SLOTS, RING_GEN = 4096, 4, 32


def _ring_trace(model, params, smi, label, lens=None, gen=RING_GEN, seed=13, **engine_kw):
    """One engine over a trace of prompts of ``lens`` tokens (``gen`` greedy
    tokens each), after ``warm()``: tokens, launches, the engine and the
    trace's record for ``_twin_gate``. Every logit row the engine's
    dispatches return must be finite; one decode specialization, and no
    new prefill_slots one after ``warm()``."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.engine import Request, ServeEngine

    cfg = model.cfg
    lens = lens or RING_PROMPTS
    rng = np.random.default_rng(seed)
    reqs = [Request(uid=u, prompt=rng.integers(0, cfg.vocab_size, n, dtype=np.int32),
                    max_new_tokens=gen) for u, n in enumerate(lens)]
    eng = ServeEngine(model, params, num_slots=RING_SLOTS, max_seq=max(lens) + gen,
                      window=RING_WINDOW, device=DEVICE, **engine_kw)
    eng.warm(lens, gen_tokens=2)
    warmed = eng.compiles
    finite = []
    _tap(eng, finite)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    outs = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eng.graphs.tap = None
    check(eng.compiles["decode"] == 1 and eng.compiles["prefill_slots"] == warmed["prefill_slots"],
          f"{label}: specializations {warmed} after warm() -> {eng.compiles}")
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    check(len(outs) == len(lens) and all(len(o.tokens) == gen for o in outs),
          f"{label}: not every request met its budget")
    check(bool(torch.stack(finite).all()), f"{label}: non-finite logits")
    tokens = sum(len(o.tokens) for o in outs)
    ttft = float(np.percentile([o.ttft for o in outs], 50))
    lat = float(np.percentile([o.latency for o in outs], 50))
    log(f"[ring-main] {label} ({smi}): {len(outs)} requests, {tokens} tokens in {wall:.3f} s: "
        f"{tokens / wall:.1f} tok/s, TTFT p50 {ttft * 1e3:.1f} ms, latency p50 "
        f"{lat * 1e3:.1f} ms; {eng.steps} decode steps, {eng.prefill_dispatches} prefill "
        f"dispatches, {eng.prefill_tokens} prefill tokens; launches {launches}; compiles "
        f"{eng.compiles}; graph pool {_pool_gb(eng)}")
    return {o.uid: o.tokens for o in outs}, launches, eng, _record(outs, wall, eng, launches)


def _ring_logit_parity(model, params, cfg):
    """One decode step from a ring engine's cache after it admitted four of
    the trace's prompts and decoded once (positions 6145, 5001, 701, 97: two
    rows wrapped, two short of the ring): the kernel that skips dead pages,
    the one that streams every slot (bitwise the same logits), the plain
    version and its planted faults. (Dropping the newest key of a row of
    thousands moves the logits by less than the bf16 tolerance; the 97-key
    row shows it.)"""
    import torch

    from repro_torch.launch.engine import Request, ServeEngine

    eng = ServeEngine(model, params, num_slots=RING_SLOTS, max_seq=max(RING_PROMPTS) + RING_GEN,
                      window=RING_WINDOW, device=DEVICE)
    rng = np.random.default_rng(17)
    for u, n in enumerate((6144, 5000, 700, 96)):
        eng.submit(Request(uid=u, prompt=rng.integers(0, cfg.vocab_size, n, dtype=np.int32),
                           max_new_tokens=RING_GEN))
    eng.step()
    feed = torch.zeros((eng.num_slots, 1), dtype=torch.int32, device=DEVICE)
    snap = {k: v.clone() for k, v in eng.cache.items()}

    def step(paged=True):
        twin = {k: v.clone() for k, v in snap.items()}
        _, lg = eng.model.decode(eng.params, twin, feed, window=eng.window, paged=paged)
        return lg[:, : cfg.vocab_size]

    lk = step()
    check(bool(torch.isfinite(lk).all()), "ring decode step: non-finite logits")
    same = torch.equal(lk, step(paged=False))
    expect(same, "ring decode step: paged_decode_ring and swa_decode logits not bitwise equal")
    with plain_kernels():
        lp = step()
    tol = LOGIT_RTOL[cfg.dtype]
    scale = max(lp.abs().max().item(), 1.0)
    d = (lk - lp).abs().max().item()
    expect(d <= tol * scale, f"ring decode step: logit diff {d} too large")
    msg = (f"[ring-main] {cfg.dtype} decode step at positions {snap['pos'].tolist()}: swa vs "
           f"paged logits bitwise equal: {same}; kernel vs plain max |dlogit| {d:.3e} = "
           f"{d / scale:.3e} x logit scale {scale:.2f} (tol {tol:g} x scale)")
    for fname, kind in RING_FAULTS:
        with plain_kernels(ring_decode=_ring_fault(kind)):
            fd = (lk - step()).abs().max().item()
        msg += f"; planted fault '{fname}' {fd:.3e} = {fd / scale:.3e} x scale"
        expect(fd > tol * scale, f"ring decode step: planted fault '{fname}' within tolerance")
    log(msg)
    del snap, eng


def phase_main_path_ring(smi):
    """Ring mode at stablelm-1.6b's published widths (bf16, seeded weights):
    4 slots of 4096-slot rings (window 4096), chunked prefill, 6 prompts of
    6144/5000/2048/700/300/96 tokens x 32. Gates: budgets, finite logits,
    paged_decode_ring and flash_prefill launched (swa_decode in the run
    with paged decode off), one decode step's logits
    (kernel vs plain within tolerance, swa == paged bitwise, planted faults
    outside; from an engine that admitted four of the prompts and decoded
    once). Printed: the same trace with paged decode off (swa_decode),
    the decode step's host wall, device time, launches and idle share for
    both, the same trace over the windowed paged pool (token agreement),
    and an interleaved trace of 4 prompts of <= 64 tokens x 16. Returns
    the ring kernels' launches (paged_decode_ring's from the main run,
    swa_decode's from the run with paged decode off) and the model and
    parameters for 5d, and the main run's tokens and record for 5p."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    cfg = get_config("stablelm-1.6b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
    toks, launches, eng, graphed = _ring_trace(model, params, smi, "ring, chunked, paged decode")
    check(launches.get("paged_decode_ring", 0) > 0 and launches.get("flash_prefill", 0) > 0
          and not launches.get("swa_decode"), f"ring main path launches: {launches}")
    ring_bytes = sum(eng.cache[n].numel() * eng.cache[n].element_size() for n in ("k", "v"))
    log(f"[ring-main] rings: {RING_SLOTS} slots x {eng.cache['k'].shape[2]} slots x "
        f"{cfg.n_layers} layers, {ring_bytes / 1e9:.2f} GB of K and V")
    _profile_decode(eng, smi, label="profile ring paged")
    del eng
    torch.cuda.empty_cache()
    # 5g: the same trace with every dispatch eager
    *_, eng, eager = _ring_trace(model, params, smi, "ring, chunked, paged decode, eager",
                                 graphs=False)
    _twin_gate("rings", smi, graphed, eager)
    _profile_decode(eng, smi, label="profile ring paged")
    del eng
    torch.cuda.empty_cache()
    _ring_logit_parity(model, params, cfg)
    torch.cuda.empty_cache()
    toks_swa, l_swa, eng, _ = _ring_trace(model, params, smi, "ring, chunked, swa decode",
                                       paged_decode=False)
    check(l_swa.get("swa_decode", 0) > 0 and not l_swa.get("paged_decode_ring"),
          f"swa run launches: {l_swa}")
    _profile_decode(eng, smi, label="profile ring swa")
    del eng
    torch.cuda.empty_cache()
    toks_pg, l_pg, eng, _ = _ring_trace(model, params, smi, "windowed paged pool, page 16",
                                     paged_cache=True, page_size=16)
    check(l_pg.get("paged_decode", 0) > 0, f"windowed paged run launches: {l_pg}")
    del eng
    torch.cuda.empty_cache()

    def match(a, b):
        return sum(a[u] == b[u] for u in a) / len(a)

    log(f"[ring-main] token agreement with the ring/paged-decode run: swa decode "
        f"{match(toks, toks_swa):.3f}, windowed paged pool {match(toks, toks_pg):.3f} of "
        "requests (bf16, random weights; no gate)")
    _, l_il, eng, _ = _ring_trace(model, params, smi, "ring, interleaved", lens=(64, 48, 33, 17),
                               gen=16, prefill="interleaved")
    check(l_il.get("paged_decode_ring", 0) > 0 and not l_il.get("flash_prefill")
          and eng.prefill_dispatches == 0, f"interleaved run launches: {l_il}")
    del eng
    torch.cuda.empty_cache()
    return ({"paged_decode_ring": launches["paged_decode_ring"],
             "swa_decode": l_swa["swa_decode"]}, model, params,
            dict(tokens=toks, record=graphed))


# ----------------------------------------------------------------- phase 5d
def phase_serve_batch(smi, model, params):
    """The single-batch path at full width: batch 4, prompt 64, gen 64,
    window 96 (the ring wraps at step 96) through its decode-and-argmax
    graph; swa_decode must launch; then with every step eager: the same
    tokens and launches."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.engine import synthetic_prompts
    from repro_torch.launch.graphs import GraphCache
    from repro_torch.launch.serve import generate_batch

    cfg = model.cfg
    prompts = torch.from_numpy(synthetic_prompts(cfg, 4, 64, 0)).to(DEVICE)
    runs = {}
    for graphed in (True, False):
        graphs = GraphCache(DEVICE, enabled=graphed)
        torch.cuda.synchronize()
        ops.reset_launches()
        gen, t_prefill, t_gen = generate_batch(model, params, prompts, 64, window=96,
                                               graphs=graphs)
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        runs[graphed] = (gen, launches, graphs.counts)
        check(gen.shape == (4, 64) and bool(((gen >= 0) & (gen < cfg.vocab_size)).all()),
              f"serve_batch output {tuple(gen.shape)} out of range")
        check(launches.get("swa_decode", 0) > 0 and not launches.get("paged_decode_ring"),
              f"serve_batch launches: {launches}")
        check(graphs.counts == {"decode": 1}, f"serve_batch compiles {graphs.counts}")
        log(f"[serve-batch] ({smi}), {'graphed' if graphed else 'eager'}: batch 4, prompt 64 "
            f"teacher-forced in {t_prefill:.3f} s, 64 tokens/row in {t_gen:.3f} s: "
            f"{4 * 64 / t_gen:.1f} tok/s; window 96, ring 96 slots; launches {launches}; "
            f"compiles {graphs.counts}; graph pool "
            f"{graphs.pool_bytes() / 1e9:.3f} GB")
        del graphs
    same = torch.equal(runs[True][0], runs[False][0]) and runs[True][1] == runs[False][1]
    expect(same, "graphs vs eager, serve_batch: tokens or launches differ")
    log(f"[graphs] serve_batch ({smi}): graphed vs eager tokens and launches equal: {same}")


# ----------------------------------------------------------------- phase 5h
class _HostRead:
    """A model whose decode reads a logit on the host (``.item()``): the
    planted fault the decode graph's capture must refuse."""

    def __init__(self, model):
        self.model = model

    def decode(self, *a, **kw):
        cache, logits = self.model.decode(*a, **kw)
        return cache, logits * float(logits[0, 0].item() == logits[0, 0].item())

    def __getattr__(self, name):
        return getattr(self.model, name)


def phase_graph_fault(smi):
    """5h: a host read inside a captured region raises at capture, with no
    eager fallback: an engine (the smoke config, bf16) over a model whose
    decode calls ``.item()`` admits a request eagerly, then its first decode
    step's capture must raise; the same engine with ``graphs=False`` serves
    the request. A capture whose Python allocates past the cyclic
    collector's thresholds, beside a dead graph cache in a reference cycle,
    must hold."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.engine import Request, ServeEngine
    from repro_torch.launch.graphs import GraphCache
    from repro_torch.models.model import build_model

    cfg = get_smoke_config("stablelm-1.6b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
    req = lambda: Request(uid=0, prompt=np.arange(1, 9, dtype=np.int32),  # noqa: E731
                          max_new_tokens=3)
    eng = ServeEngine(_HostRead(model), params, num_slots=2, max_seq=16, device=DEVICE)
    eng.submit(req())
    raised = None
    try:
        eng.run()
    except Exception as e:  # noqa: BLE001 (any capture error passes the gate)
        raised = e
    check(raised is not None, "a host read inside the decode graph did not raise at capture")
    check(eng.compiles["decode"] == 0, f"a failed capture was counted: {eng.compiles}")
    del eng
    gc.collect()
    out = ServeEngine(_HostRead(model), params, num_slots=2, max_seq=16, device=DEVICE,
                      graphs=False).run([req()])
    check(len(out) == 1 and len(out[0].tokens) == 3, "the eager engine did not serve")
    # a dead graph cache in a reference cycle (as engines are) is not
    # collected inside another capture: CUDA refuses to destroy a graph
    # while a stream captures, which invalidates the capture
    dead = GraphCache(DEVICE)
    x = torch.ones(256, device=DEVICE)
    for _ in range(2):
        dead("f", (), lambda t: t * 2, x)
    dead.me = dead
    del dead

    def churn(t):
        if torch.cuda.is_current_stream_capturing():
            junk = [[] for _ in range(20000)]   # past the collector's thresholds
            del junk
        return t + 1

    live = GraphCache(DEVICE)
    got = [live("g", (), churn, torch.ones(4)).clone() for _ in range(2)]
    torch.cuda.synchronize()
    check(all(g.tolist() == [2.0] * 4 for g in got) and gc.isenabled(),
          f"a capture beside a dead graph in a cycle: {got}")
    log(f"[graph-fault] ({smi}): a decode that calls .item() raised at capture "
        f"({type(raised).__name__}: {str(raised).splitlines()[0][:120]}); with graphs=False "
        "the same model served its request; a capture that allocates past the collector's "
        "thresholds beside a dead graph in a reference cycle held")


# ------------------------------------------------------------------ phase 6
def _short(kernel: str) -> str:
    """A profiler kernel name without its namespace and argument list."""
    return kernel.replace("(anonymous namespace)::", "").split("(")[0][-48:]


def phase_channel_kernels(smi):
    """The four channel kernels against their plain versions at the
    training path's leaves, each with a planted fault; top-k and int8 also
    on the sync's kind of update and on edge blocks; times at the embedding
    leaf."""
    import torch

    import channel_cases as cc
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.dp_clip import CHUNK

    gen = torch.Generator(device=DEVICE).manual_seed(3)
    k = ops.topk_k(TOPK_RATIO)
    one = torch.ones((), device=DEVICE)
    scale = torch.tensor(0.37, device=DEVICE)
    sigma = 0.05
    rows = {}

    def bitwise(name, what, out, plain, faults):
        e = (out.float() - plain.float()).abs().max().item()
        expect(torch.equal(out, plain), f"{name} {what}: kernel differs from plain (max {e})")
        msg = f"[channel] {name} {what}: bitwise equal {torch.equal(out, plain)}, max_abs_err {e:.3e}"
        for fname, fout in faults:
            bad = torch.equal(out, fout)
            expect(not bad, f"{name} {what}: planted fault '{fname}' not caught")
            msg += f"; planted fault '{fname}' differs: {not bad}"
        log(msg)
        return e

    def rel(a, b):
        return abs(a.item() - b.item()) / abs(b.item())

    for lname, shape in (("embed 100352x2048", (100352 * 2048,)),
                         ("mlp 24x2048x5632", (24, 2048, 5632))):
        x = torch.randn(shape, generator=gen, device=DEVICE) * 1e-3
        noise = torch.randn(shape, generator=gen, device=DEVICE)
        n = x.numel()
        errs = {
            "topk_sparsify": bitwise("topk_sparsify", f"{lname} k={k}",
                                     ops.topk_sparsify_leaf(x, TOPK_RATIO),
                                     ref.topk_sparsify_ref(x, k),
                                     [("keeps k-1 per block", cc.topk_short(x, k))]),
            "int8_roundtrip": bitwise("int8_roundtrip", lname, ops.int8_roundtrip_leaf(x),
                                      ref.int8_roundtrip_ref(x),
                                      [("divisor 128", cc.int8_div128(x))]),
            "clip_noise": bitwise("clip_noise", f"{lname} scale 1, sigma {sigma}",
                                  ops.clip_noise(x, one, noise, sigma),
                                  ref.clip_noise_ref(x, one, noise, sigma),
                                  [("noise term left out", ref.clip_noise_ref(x, one))]),
        }
        bitwise("clip_noise", f"{lname} clip scale 0.37, no noise", ops.clip_noise(x, scale),
                ref.clip_noise_ref(x, scale), [("scale left out", x)])
        xb = x.bfloat16()
        bitwise("clip_noise", f"{lname} bf16 scale 0.37, sigma {sigma}",
                ops.clip_noise(xb, scale, noise, sigma),
                ref.clip_noise_ref(xb, scale, noise, sigma),
                [("noise term left out", ref.clip_noise_ref(xb, scale))])
        bitwise("clip_noise", f"{lname} bf16 clip scale 0.37, no noise",
                ops.clip_noise(xb, scale), ref.clip_noise_ref(xb, scale), [("scale left out", xb)])
        flat = x.reshape(-1)
        # a view 4 bytes past a 16-byte boundary, x and noise alike
        xv, nv = flat[1:], noise.reshape(-1)[1:]
        bitwise("clip_noise", f"{lname} view at +4 bytes, sigma {sigma}",
                ops.clip_noise(xv, scale, nv, sigma), ref.clip_noise_ref(xv, scale, nv, sigma),
                [("noise term left out", ref.clip_noise_ref(xv, scale))])
        ragged = flat[: 1_000_077]
        got, want = ops.sq_norm(x), ref.sq_norm_ref(x)
        again = ops.sq_norm(x)
        got_b, want_b = ops.sq_norm(xb), ref.sq_norm_ref(xb)
        expect(torch.equal(got, again), f"sq_norm {lname}: two calls differ ({got} vs {again})")
        expect(rel(got_b, want_b) <= SQ_NORM_RTOL, f"sq_norm {lname} bf16: {rel(got_b, want_b)}")
        got_r, want_r = ops.sq_norm(ragged), ref.sq_norm_ref(ragged)
        f_chunk = rel(got, ref.sq_norm_ref(flat[:-CHUNK]))
        f_tail = rel(got_r, ref.sq_norm_ref(ragged[:1_000_000]))
        errs["sq_norm"] = abs(got.item() - want.item())
        expect(rel(got, want) <= SQ_NORM_RTOL, f"sq_norm {lname}: rel err {rel(got, want)}")
        expect(rel(got_r, want_r) <= SQ_NORM_RTOL, f"sq_norm ragged: {rel(got_r, want_r)}")
        expect(f_chunk > SQ_NORM_RTOL and f_tail > SQ_NORM_RTOL,
               f"sq_norm planted faults not caught: {f_chunk}, {f_tail}")
        log(f"[channel] sq_norm {lname}: rel err {rel(got, want):.3e} (tol {SQ_NORM_RTOL:g}); "
            f"bf16 rel err {rel(got_b, want_b):.3e}; a second call bitwise equal "
            f"{torch.equal(got, again)}; ragged n=1000077 rel err {rel(got_r, want_r):.3e}; "
            "planted faults: last "
            f"{CHUNK}-element chunk dropped {f_chunk:.3e}, ragged tail dropped {f_tail:.3e}")
        # the sync's kind of update (a bf16-grid difference times a clip
        # scale: the k-th magnitude ties in most blocks), and edge blocks
        # planted into it (all zeros, 1 or 2 nonzeros at k = 3, int8 half
        # steps), whole, at a ragged length and as a view 4 bytes on
        u = cc.bf16_grid_update(torch.randn(shape, generator=gen, device=DEVICE) * 0.02,
                                torch.randn(shape, generator=gen, device=DEVICE))
        edge = cc.plant_edge_blocks(u).reshape(-1)
        div128 = ("divisor 128", cc.int8_div128)
        half_away = ("rounds half away from zero", cc.int8_half_away)
        for cname, xc, int8_faults in (
                ("bf16-grid update", u, (div128,)),
                ("edge blocks", edge, (half_away, div128)),
                ("edge blocks, ragged n=1000077", edge[:1_000_077], (half_away,)),
                ("edge blocks, view at +4 bytes", edge[1:], (half_away,))):
            st = cc.tie_stats(xc, k)
            log(f"[channel] {lname} {cname}: of {st['blocks']} blocks, k-th magnitude tied in "
                f"{st['kth_tied']:.4f}, all zeros {st['all_zero']:.4f}, fewer than {k} nonzeros "
                f"{st['under_k_nonzero']:.4f}; top-k rounds per block {st['rounds']:.4f}")
            e_t = bitwise("topk_sparsify", f"{lname} {cname} k={k}",
                          ops.topk_sparsify_leaf(xc, TOPK_RATIO), ref.topk_sparsify_ref(xc, k),
                          [("keeps exactly k per block", cc.topk_exact_k(xc, k))])
            e_q = bitwise("int8_roundtrip", f"{lname} {cname}", ops.int8_roundtrip_leaf(xc),
                          ref.int8_roundtrip_ref(xc), [(f, fn(xc)) for f, fn in int8_faults])
            errs["topk_sparsify"] = max(errs["topk_sparsify"], e_t)
            errs["int8_roundtrip"] = max(errs["int8_roundtrip"], e_q)
        del edge
        if lname.startswith("embed"):
            rounds = {what: cc.tie_stats(xc, k)["rounds"] for what, xc in (("x", x), ("u", u))}
            timing = {
                "topk_sparsify": (lambda: ops.topk_sparsify_leaf(x, TOPK_RATIO),
                                  lambda: ref.topk_sparsify_ref(x, k), None,
                                  8 * n, n * (2 + 2 * rounds["x"])),
                "int8_roundtrip": (lambda: ops.int8_roundtrip_leaf(x),
                                   lambda: ref.int8_roundtrip_ref(x), None, 8 * n, 6 * n),
                # logged beside the rows: both on the sync's kind of update
                "topk_sparsify bf16-grid update": (
                    lambda: ops.topk_sparsify_leaf(u, TOPK_RATIO),
                    lambda: ref.topk_sparsify_ref(u, k), None, 8 * n, n * (2 + 2 * rounds["u"])),
                "int8_roundtrip bf16-grid update": (lambda: ops.int8_roundtrip_leaf(u),
                                                    lambda: ref.int8_roundtrip_ref(u), None,
                                                    8 * n, 6 * n),
                "sq_norm": (lambda: ops.sq_norm(x), lambda: ref.sq_norm_ref(x),
                            lambda: torch.dot(flat, flat), 4 * n + 4, 2 * n),
                "clip_noise": (lambda: ops.clip_noise(x, one, noise, sigma),
                               lambda: ref.clip_noise_ref(x, one, noise, sigma),
                               lambda: torch.add(x, noise, alpha=sigma), 12 * n + 4, 3 * n),
                # logged beside the rows: the clip alone (x read, out
                # written) and the norm of a bf16 leaf (the library call
                # returns the norm, whose square is the function)
                "clip_noise sigma 0": (lambda: ops.clip_noise(x, scale),
                                       lambda: ref.clip_noise_ref(x, scale),
                                       lambda: torch.mul(x, scale), 8 * n + 4, n),
                "sq_norm bf16": (lambda: ops.sq_norm(xb), lambda: ref.sq_norm_ref(xb),
                                 lambda: torch.linalg.vector_norm(xb, dtype=torch.float32),
                                 2 * n + 4, 2 * n),
            }
            for name, (kern, plain, lib, nbytes, flops) in timing.items():
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = flops / FP32_FLOPS * 1e3
                bound = max(t_bytes, t_ops)
                ms, wall = timed_ms(kern, bound_ms=bound)
                split = "; ".join(f"{_short(key)} x{c:g} {t:.4f} ms"
                                  for key, (c, t) in LAST_KERNELS.items())
                r = dict(
                    max_abs_err=errs.get(name, 0.0), ms=ms, wrapper_ms=wall,
                    plain_ms=timed_ms(plain, iters=5, bound_ms=bound)[0],
                    library_ms=None if lib is None else timed_ms(lib, bound_ms=bound)[0],
                    bound_ms=bound,
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                )
                if name in CHANNEL:
                    rows[name] = r
                lib_ms = "null" if lib is None else format(r["library_ms"], ".4f")
                log(f"[channel] {name} {lname} ({smi}): kernel device ms {r['ms']:.4f} "
                    f"(CUDA events per call, back to back {r['wrapper_ms']:.4f}) "
                    f"plain_ms {r['plain_ms']:.4f} "
                    f"library_ms {lib_ms} bound_ms {r['bound_ms']:.4f} ({r['bound_by']}: "
                    f"{nbytes / 1e9:.3f} GB); kernels per call: {split}")
        else:
            for name, e in errs.items():
                rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], e)
        del x, xb, noise, flat, ragged, xv, nv, u
    torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------------ phase 7
def _stage(kernel_name: str) -> str:
    """The sync-round stage a device kernel belongs to, by its name."""
    n = kernel_name.lower()
    if "clip_noise_kernel" in n:
        return "noise" if "true" in n else "clip"
    if "sq_norm" in n:
        return "clip"
    if "topk" in n:
        return "top-k"
    if "int8" in n:
        return "int8"
    if "normal" in n or "philox" in n:
        return "noise"
    return "delta/EF/aggregate"


def _dp_split(ev) -> str:
    """Device ms and launches of the DP kernels among profiler kernel rows."""
    parts = []
    for name in ("sq_norm", "clip_noise"):
        es = [e for e in ev if name in e.key]
        parts.append(f"{name} {sum(e.self_device_time_total for e in es) / 1e3:.3f} ms in "
                     f"{sum(e.count for e in es)} launches")
    return ", ".join(parts)


def _timed_run(label: str, *, on_sync=None, on_step=None, **overrides):
    """``run_training`` at ``TRAIN``'s settings with ``overrides`` on the
    card, each step's local part and its sync round timed apart (the
    trainer's own ``_sync`` is kept as ``trainer.__dict__["untimed_sync"]``).
    ``on_sync(state, arrived)``, if given, runs before each sync round and
    returns a callable run after it, both outside the timed region;
    ``on_step(trainer, state)`` runs after each step. Returns (result,
    walls, launches, peak GB, total s)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.train import run_training

    walls = {"local": [], "sync": [], "hooks": []}

    def step_fn(trainer, state, b, arrived, alphas):
        if "untimed_sync" not in trainer.__dict__:   # time the sync round on its own
            sync = trainer._sync

            def timed_sync(st, arr, alp):
                t_hook = time.perf_counter()
                after = on_sync(st, arr) if on_sync else None
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = sync(st, arr, alp)
                torch.cuda.synchronize()
                walls["sync"].append(time.perf_counter() - t)
                t_after = time.perf_counter()
                if after:
                    after()
                walls["hooks"].append(t - t_hook + time.perf_counter() - t_after)
                return out
            trainer.__dict__["untimed_sync"] = sync
            trainer._sync = timed_sync
        n_sync = len(walls["sync"])
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = trainer.train_step(state, b, arrived, alphas)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        if len(walls["sync"]) > n_sync:
            wall -= walls["sync"][-1] + walls["hooks"][-1]
        walls["local"].append(wall)
        if on_step:
            on_step(trainer, out[0])
        return out

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = run_training(**dict(TRAIN, **overrides), device=DEVICE, log_every=1,
                       log_fn=lambda m: log(f"[{label}] {m}"), step_fn=step_fn)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    return res, walls, dict(ops.LAUNCHES), torch.cuda.max_memory_allocated() / 1e9, total


def _run_summary(res, walls, launches, peak, total) -> tuple[str, list]:
    """The log line of a training run, and its per-cloud losses; checks
    finite losses and every channel kernel launched."""
    clouds, batch, seq = TRAIN["n_clouds"], TRAIN["per_cloud_batch"], TRAIN["seq_len"]
    losses = [x for h in res["history"] for x in h["per_cloud_loss"]]
    check(len(res["history"]) == TRAIN["steps"] and all(np.isfinite(losses)),
          f"non-finite losses: {losses}")
    check(all(launches[k] > 0 for k in CHANNEL), f"a channel kernel never launched: {launches}")
    steady = walls["local"][1:]
    local = sum(steady) / len(steady)
    syncs = ", ".join(f"{w * 1e3:.1f}" for w in walls["sync"]) or "none (every step aggregates)"
    return (f"{res['params']:,} parameters, {clouds} clouds x "
            f"{res['trainer'].model.cfg.n_layers} layers, {TRAIN['steps']} steps in {total:.3f} s "
            f"incl. init; local step walls (both clouds) "
            f"{', '.join(f'{w * 1e3:.1f}' for w in walls['local'])} ms, steady "
            f"{local * 1e3:.1f} ms = {clouds * batch * seq / local:.0f} tokens/s; sync round walls "
            f"{syncs} ms; peak memory {peak:.2f} GB (max_memory_allocated); uplink "
            f"{res['bytes_per_cloud_per_sync']:,} B per cloud per sync (wire model); losses "
            f"{losses}; launches { {k: launches[k] for k in CHANNEL} }"), losses


def _sync_parity(label, trainer, state, arrived, alphas, faults=()):
    """One sync round from a copy of the trained state (clouds, error
    feedback, global params and outer state, ``loss_accum``, the noise
    seed; the optimizer states dropped) through the kernels, then through
    the plain versions and each planted fault (name, ``plain_channel``
    swaps): the new global params must agree within ``SYNC_DIFF_FRAC``, a
    fault must not. The copy of what a sync writes in place (cloud params,
    error feedback, the outer momentum) stays on the card; the global params,
    which a sync replaces and never writes, are kept as they are, and the
    kernel run's result goes to the host."""
    import torch

    from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

    for c in state["clouds"]:
        c["opt"] = None                      # the sync reads no optimizer state
    torch.cuda.empty_cache()
    like = state["global"]["params"]
    snap = {"clouds": [[x.clone() for x in tree_leaves(c["params"])] for c in state["clouds"]],
            "ef": [[x.clone() for x in tree_leaves(t)] for t in state.get("ef", [])],
            "global": tree_leaves(like),
            "outer": tree_map(torch.clone, state["global"]["outer"]),
            "loss_accum": state["loss_accum"].clone()}

    def sync_from_copy():
        for c, saved in zip(state["clouds"], snap["clouds"]):
            for p, s in zip(tree_leaves(c["params"]), saved):
                p.copy_(s)
        for t, saved in zip(state.get("ef", []), snap["ef"]):
            for e, s in zip(tree_leaves(t), saved):
                e.copy_(s)
        state["global"] = {"params": tree_unflatten(like, snap["global"]),
                           "outer": tree_map(torch.clone, snap["outer"])}
        state["loss_accum"] = snap["loss_accum"].clone()
        state["rng"] = torch.Generator(device=DEVICE).manual_seed(NOISE_SEED)
        torch.cuda.empty_cache()   # the last round's freed blocks, split every which way
        trainer.__dict__["untimed_sync"](state, arrived, alphas)
        torch.cuda.synchronize()
        return tree_leaves(state["global"]["params"])

    torch.cuda.reset_peak_memory_stats()
    got = [x.to("cpu", copy=True) for x in sync_from_copy()]

    def compare(what, swap=None):
        with plain_channel(**(swap or {})):
            new = sync_from_copy()
        differ = total_n = beyond = 0
        worst = 0.0
        for a, b in zip(new, got):
            b = b.to(DEVICE)
            d = (a.float() - b.float()).abs()
            differ += int((d > 0).sum())
            beyond += int((d > 2.0**-7 * b.float().abs()).sum())
            total_n += d.numel()
            worst = max(worst, d.max().item())
        frac = differ / total_n
        sound = frac <= SYNC_DIFF_FRAC and beyond == 0
        if swap is not None:
            expect(not sound, f"{label} sync round: planted fault '{what}' not caught ({frac})")
        else:
            expect(sound, f"{label} sync round kernels vs {what}: {differ} of {total_n} differ, "
                          f"{beyond} by more than one bf16 ulp")
        log(f"[{label}] sync round, new global params, kernels vs {what}: {differ} of {total_n} "
            f"differ (fraction {frac:.3e}, tol {SYNC_DIFF_FRAC:g}), {beyond} by more than one "
            f"bf16 ulp, max |diff| {worst:.3e}; peak memory so far "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    compare("plain versions")
    for what, swap in faults:
        compare(f"planted fault: {what}", swap)
    del snap, got
    torch.cuda.empty_cache()


def _wan_sync_line(smi, res) -> str:
    """The modelled WAN wall of one sync round (``core/protocols.py``,
    ``Link()``'s defaults, 4 streams) at the run's uplink bytes and at the
    uncompressed update's (the wire model's count: 2 B per bf16 parameter),
    per protocol and topology."""
    from repro_torch.core.compression import Compressor
    from repro_torch.core.protocols import PROTOCOLS, Link, sync_wall_time

    link, n = Link(), TRAIN["n_clouds"]
    parts = []
    for what, nbytes in (("topk+int8", res["bytes_per_cloud_per_sync"]),
                         ("uncompressed", Compressor("none").bytes_per_sync(
                             res["state"]["global"]["params"]))):
        walls = ", ".join(f"{p} {topo} {sync_wall_time(nbytes, n, PROTOCOLS[p], link, 4, topo):.4f}"
                          for p in PROTOCOLS for topo in ("star", "ring"))
        parts.append(f"{what} ({nbytes:,} B per cloud): {walls}")
    return (f"[train] {smi}: modelled WAN sync wall in s ({n} clouds, Link(): "
            f"{link.latency_s * 1e3:g} ms one way, {link.bandwidth * 8 / 1e9:g} Gbit/s, loss "
            f"{link.loss_rate:g}; 4 streams; core/protocols.py): " + "; ".join(parts))


def phase_training(smi):
    """Federated training of stablelm-1.6b at its published widths, then a
    kernel-vs-plain sync round from a copy of the trained state."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import channel_cases

    batch, seq = TRAIN["per_cloud_batch"], TRAIN["seq_len"]
    res, walls, launches, peak, total = _timed_run("train")
    line, _ = _run_summary(res, walls, launches, peak, total)
    log(f"[train] {smi}: {line}; {torch.cuda.memory_allocated() / 1e9:.2f} GB held after the "
        f"run; all launches {launches}")
    log(_wan_sync_line(smi, res))

    trainer, state = res["trainer"], res["state"]
    del res
    # the device idle share of one local step (cloud 0, one fresh batch)
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    toks = torch.randint(0, trainer.model.cfg.vocab_size, (batch, seq + 1), generator=gen,
                         device=DEVICE, dtype=torch.int32)
    b0 = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    cloud = state["clouds"][0]
    trainer._local_step(cloud, b0)
    torch.cuda.synchronize()
    t = time.perf_counter()
    trainer._local_step(cloud, b0)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer._local_step(cloud, b0)
        torch.cuda.synchronize()
    ev = _kernel_rows(prof)
    dev_ms = sum(e.self_device_time_total for e in ev) / 1e3
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:4]
    log(f"[train] {smi}: one local step (1 cloud, {batch} x {seq}) host wall {host_ms:.1f} ms, "
        f"device time {dev_ms:.1f} ms in {sum(e.count for e in ev)} kernel launches, device "
        f"idle share {max(0.0, 1 - dev_ms / host_ms):.3f}; the gradient clip: {_dp_split(ev)}"
        "; top: "
        + "; ".join(f"{e.key[:40]} x{e.count} {e.self_device_time_total / 1e3:.1f} ms"
                    for e in top))

    # the sync round's device time by stage, from the trained state
    arrived = torch.ones(TRAIN["n_clouds"], dtype=torch.bool, device=DEVICE)
    alphas = torch.full((TRAIN["n_clouds"],), 0.5, device=DEVICE)
    for c in state["clouds"]:
        c["opt"] = None
    torch.cuda.empty_cache()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        trainer.__dict__["untimed_sync"](state, arrived, alphas)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t) * 1e3
    stages: dict[str, float] = {}
    ev = _kernel_rows(prof)
    for e in ev:
        stages[_stage(e.key)] = stages.get(_stage(e.key), 0.0) + e.self_device_time_total / 1e3
    log(f"[train] {smi}: profiled sync round wall {prof_wall:.1f} ms, device time "
        f"{sum(stages.values()):.2f} ms by stage: "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(stages.items(), key=lambda x: -x[1]))
        + f"; of which {_dp_split(ev)}")
    # one sync round from a copy of the trained state: kernels, plain, faults
    _sync_parity("train", trainer, state, arrived, alphas, faults=(
        ("top-k keeps k-1 per block", {"topk_sparsify": channel_cases.topk_short}),
        ("top-k keeps exactly k per block (ties dropped)",
         {"topk_sparsify": channel_cases.topk_exact_k})))
    del state, trainer
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------ phases 7b-7e
# the other aggregators at full width: (label, TRAIN overrides)
AGGREGATORS_7B = (("gradient", dict(aggregation="gradient")),
                  ("async", dict(aggregation="async")),
                  ("nesterov", dict(outer_optimizer="nesterov")),
                  ("dynamic", dict(aggregation="dynamic")))
# One local step's fp32 gradients at 2 microbatches against 1, per leaf by
# relative L2: the bf16 gradients of two half batches (GEMMs of other
# shapes, each gradient rounded to bf16 before the fp32 sum) differ from
# the whole batch's by a few bf16 ulps (2**-8 relative) of each element;
# summing the halves without dividing by 2 reads 1.0.
MICROBATCH_RTOL = 0.05
# secure aggregation: a masked transmit equals its fixed-point update where
# the mask is 0 (odds 2**-32 per element: ~0.4 of 1.64e9); more than this
# many is a mask that was not drawn
SECURE_SAME_MAX = 8


def phase_training_aggregators(smi):
    """7b: gradient, async, fedavg with the nesterov outer optimizer and
    dynamic at ``TRAIN``'s settings, each gated on its own invariant, and a
    kernel-vs-plain sync round for async, nesterov and dynamic; 7d runs on
    the params the dynamic run's first sync saw, copied to the host there and
    taken up after the run. Returns the dynamic run's model and global params
    for 7c and 7e."""
    import torch

    from repro_torch.utils.tree import tree_leaves

    n = TRAIN["n_clouds"]
    snap_7d: dict = {}
    for label, overrides in AGGREGATORS_7B:
        t_run = time.perf_counter()
        checks = {"steps": 0, "syncs": 0}

        def on_step(trainer, state, label=label):
            checks["steps"] += 1
            if label == "gradient":     # every cloud holds the global params after every step
                g = tree_leaves(state["global"]["params"])
                for c in state["clouds"]:
                    check(all(torch.equal(p, q) for p, q in zip(tree_leaves(c["params"]), g)),
                          f"gradient: a cloud's params differ from the global params after "
                          f"step {checks['steps']}")
            if label == "nesterov" and state["step"] % TRAIN["local_steps"] == 0:
                mom = tree_leaves(state["global"]["outer"]["momentum"])
                check(all(bool(torch.isfinite(m).all()) for m in mom),
                      "nesterov: a non-finite momentum")
                check(any(bool((m != 0).any()) for m in mom), "nesterov: the momentum is 0")
                checks["syncs"] += 1

        def on_sync(state, arrived, label=label):
            if label == "dynamic" and not checks["syncs"]:   # 7d's inputs: the first sync's
                checks["syncs"] += 1
                snap_7d.update(global_=[x.to("cpu", copy=True) for x in
                                        tree_leaves(state["global"]["params"])],
                               clouds=[[x.to("cpu", copy=True) for x in tree_leaves(c["params"])]
                                       for c in state["clouds"]])
            if label != "async":
                return None
            arr = arrived.tolist()
            check(not all(arr), "async: every cloud arrived; the mask checks nothing")
            # the late clouds' params on the host, so the gate adds nothing
            # to the sync's peak memory on the card
            before = {c: [x.to("cpu", copy=True)
                          for x in tree_leaves(state["clouds"][c]["params"])]
                      for c, a in enumerate(arr) if not a}

            def after():   # late clouds keep their params, arrived ones hold the new global
                checks["syncs"] += 1
                g = tree_leaves(state["global"]["params"])
                for c, a in enumerate(arr):
                    want = g if a else before[c]
                    check(all(torch.equal(p if a else p.cpu(), q) for p, q in
                              zip(tree_leaves(state["clouds"][c]["params"]), want)),
                          f"async sync {checks['syncs']}: cloud {c} (arrived {a}) does not hold "
                          f"{'the new global params' if a else 'its own params'}")
            return after

        res, walls, launches, peak, total = _timed_run(f"train-{label}", on_sync=on_sync,
                                                       on_step=on_step, **overrides)
        line, losses = _run_summary(res, walls, launches, peak, total)
        trainer, state = res["trainer"], res["state"]
        del res
        log(f"[train-{label}] {smi}: {line}; gates: "
            + {"gradient": f"every cloud == global after each of {checks['steps']} steps",
               "async": f"{checks['syncs']} syncs, the late cloud kept its params bitwise, "
                        "the arrived one holds the new global",
               "nesterov": f"momentum finite and nonzero after each of {checks['syncs']} syncs",
               "dynamic": "finite losses, every channel kernel launched"}[label])
        if label != "gradient":
            # the sync from the trained state, with a live loss_accum (the
            # last step's losses x H) and, for async, a mask with a late cloud
            state["loss_accum"] = torch.tensor(losses[-n:], device=DEVICE) * TRAIN["local_steps"]
            arrived = torch.tensor([c % 2 == 1 for c in range(n)], device=DEVICE)
            _sync_parity(f"train-{label}", trainer, state, arrived,
                         torch.full((n,), 0.5, device=DEVICE))
        if label == "dynamic":
            kept = trainer.model, state["global"]["params"]
        del trainer, state
        gc.collect()
        torch.cuda.empty_cache()
        if label == "dynamic":
            phase_secure_agg(smi, {"global": snap_7d["global_"], "clouds": snap_7d["clouds"]})
        log(f"[train-{label}] phase 7b run wall {time.perf_counter() - t_run:.1f} s")
    return kept


def phase_secure_agg(smi, snap):
    """7d: secure aggregation at full width on the two clouds' fp32 deltas
    at a sync round (``snap``: the clouds' and the global params' leaves on
    the host, taken by 7b's dynamic run before its first sync, where the
    error feedback is still 0), raw and DP-clipped (clip ``DP_CLIP``), one
    leaf at a time on the card (the sum does not depend on the masks):
    ``secure_aggregate`` equal to ``from_fixed(Σ to_fixed(u))`` bitwise,
    each cloud's masked transmit equal to its ``to_fixed`` update on at
    most ``SECURE_SAME_MAX`` elements; planted faults at the embedding leaf
    (one pair's mask with the wrong sign; cloud 1 on the next round) must
    not cancel. Prints its time and its relative L2 error against the fp32
    sum."""
    import torch

    from repro_torch.core import privacy
    from repro_torch.kernels import ops
    from repro_torch.optim.adamw import clip_scale
    from repro_torch.utils.tree import tree_leaves

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    g, clouds = snap["global"], snap["clouds"]
    n_el = sum(x.numel() for x in g)

    def delta(c, i):
        return clouds[c][i].to(DEVICE).float() - g[i].to(DEVICE).float()

    sq = [ops.tree_sq_norm(delta(c, i) for i in range(len(g))) for c in range(2)]
    scales = [clip_scale(x, DP_CLIP) for x in sq]
    rnd = 3
    for kind in ("raw", "DP-clipped"):
        same, err2, ref2, ms = [0, 0], 0.0, 0.0, 0.0
        for i in range(len(g)):
            u = [delta(c, i) for c in range(2)]
            if kind == "DP-clipped":
                u = [ops.clip_noise(x, s) for x, s in zip(u, scales)]
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = privacy.secure_aggregate(u, rnd)
            torch.cuda.synchronize()
            ms += (time.perf_counter() - t) * 1e3
            fixed = [privacy.to_fixed(x) for x in u]
            check(torch.equal(got, privacy.from_fixed(fixed[0] + fixed[1], torch.float32)),
                  f"secure_aggregate {kind}, leaf {i}: differs from from_fixed(sum to_fixed)")
            exact = u[0] + u[1]
            err2 += (got - exact).square().sum(dtype=torch.float64).item()
            ref2 += exact.square().sum(dtype=torch.float64).item()
            if kind == "raw":
                masked = [privacy.mask_update(f, c, 2, rnd) for c, f in enumerate(fixed)]
                for c in range(2):
                    same[c] += int((masked[c] == fixed[c]).sum())
                if i == 0:   # embed.tok: the planted faults
                    flipped = masked[1].clone()
                    pair = privacy._pair_generator(rnd, 0, 1, DEVICE)
                    flipped.add_(2 * torch.randint(-2**31, 2**31 - 1, flipped.shape,
                                                   generator=pair, dtype=torch.int32,
                                                   device=DEVICE))
                    late = privacy.mask_update(fixed[1], 1, 2, rnd + 1)
                    want = fixed[0] + fixed[1]
                    bad = {what: int((privacy.secure_sum([masked[0], m1]) != want).sum())
                           for what, m1 in (("a mask with the wrong sign", flipped),
                                            ("cloud 1 on the next round", late))}
                    for what, k in bad.items():
                        check(k > 0, f"secure aggregation: planted fault '{what}' cancelled")
                del masked
        if kind == "raw":
            check(max(same) <= SECURE_SAME_MAX, f"a masked transmit equals its fixed-point "
                                                f"update on {same} elements")
        log(f"[secure-agg] {smi}: {kind} deltas of {n_el:,} parameters x 2 clouds, one leaf at a "
            f"time: secure_aggregate bitwise from_fixed(sum to_fixed) on every leaf; "
            f"{ms:.1f} ms in secure_aggregate; relative L2 error against the fp32 sum "
            f"{(err2 / ref2) ** 0.5:.4e} (fixed point 2**-16)"
            + (f"; masked transmit == to_fixed update on {same} elements (max "
               f"{SECURE_SAME_MAX}); planted faults at embed.tok differ on {bad} elements"
               if kind == "raw" else
               f"; global norms {[x.sqrt().item() for x in sq]}, clip scales "
               f"{[x.item() for x in scales]}"))
    log(f"[secure-agg] phase 7d wall {time.perf_counter() - t_phase:.1f} s")


def phase_microbatches(smi, model, params):
    """7c: one local step's loss and fp32 gradients at ``microbatches=2``
    against ``=1`` on the same full-width params and batch (8 x 256), per
    leaf by relative L2 within ``MICROBATCH_RTOL``; the planted fault (the
    halves summed, not divided) must fail. Prints each one's peak memory."""
    import torch

    from golden_train import leaf_paths
    from repro_torch.utils.grad import microbatched_value_and_grad
    from repro_torch.utils.tree import tree_leaves

    t_phase = time.perf_counter()
    batch, seq = TRAIN["per_cloud_batch"], TRAIN["seq_len"]
    gen = torch.Generator(device=DEVICE).manual_seed(12)
    toks = torch.randint(0, model.cfg.vocab_size, (batch, seq + 1), generator=gen,
                         device=DEVICE, dtype=torch.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    for k in (1, 2):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t = time.perf_counter()
        (loss, _), grads = microbatched_value_and_grad(model.loss, params, b, k)
        torch.cuda.synchronize()
        out[k] = (loss.item(), tree_leaves(grads), (time.perf_counter() - t) * 1e3,
                  (torch.cuda.max_memory_allocated() - held) / 1e9, held / 1e9)
    (l1, g1, w1, p1, h1), (l2, g2, w2, p2, h2) = out[1], out[2]
    rels, fault = {}, 0.0
    for name, a, x in zip(leaf_paths(params), g1, g2):
        norm = a.norm().item()
        rels[name] = (x - a).norm().item() / norm
        fault = max(fault, (2 * x - a).norm().item() / norm)
    worst = max(rels, key=rels.get)
    rel = rels[worst]
    loss_rel = abs(l2 - l1) / abs(l1)
    check(rel <= MICROBATCH_RTOL and loss_rel <= MICROBATCH_RTOL,
          f"microbatches=2 vs 1: per-leaf rel L2 {rel}, loss rel {loss_rel}")
    check(fault > MICROBATCH_RTOL, f"microbatch planted fault (no division) not caught: {fault}")
    log(f"[microbatch] {smi}: one local step, {batch} x {seq}, {model.cfg.name} "
        f"({model.cfg.n_layers} layers, d {model.cfg.d_model}): loss "
        f"k=1 {l1:.6f}, k=2 {l2:.6f} (rel {loss_rel:.3e}); largest per-leaf rel L2 of the fp32 "
        f"gradients {rel:.3e} at {worst} (tol {MICROBATCH_RTOL:g}; the others "
        f"{', '.join(f'{k} {v:.1e}' for k, v in rels.items() if k != worst)}); planted fault (halves summed, not "
        f"divided) {fault:.3f}; wall k=1 {w1:.1f} ms, k=2 {w2:.1f} ms; peak memory above the "
        f"{h1:.2f} / {h2:.2f} GB held: k=1 {p1:.2f} GB, k=2 {p2:.2f} GB")
    del out, g1, g2
    torch.cuda.empty_cache()
    log(f"[microbatch] phase 7c wall {time.perf_counter() - t_phase:.1f} s")


def phase_checkpoint(smi, params):
    """7e: the bf16 global params saved in the reference's checkpoint format
    under ``build/`` and restored bitwise; the directory is removed."""
    import shutil

    import torch

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.utils.tree import tree_leaves

    t_phase = time.perf_counter()
    where = ROOT / "build" / "chip_smoke_checkpoint"
    shutil.rmtree(where, ignore_errors=True)
    try:
        ck = Checkpointer(str(where))
        torch.cuda.synchronize()
        t = time.perf_counter()
        ck.save(TRAIN["steps"], params)
        save_s = time.perf_counter() - t
        nbytes = sum(f.stat().st_size for f in where.rglob("*") if f.is_file())
        t = time.perf_counter()
        back = ck.restore(ck.latest_step(), params)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        pairs = list(zip(tree_leaves(back), tree_leaves(params)))
        check(all(a.device == b.device and a.dtype == b.dtype and torch.equal(a, b)
                  for a, b in pairs), "checkpoint: a restored leaf differs")
        n = sum(b.numel() * b.element_size() for _, b in pairs)
        log(f"[checkpoint] {smi}: {len(pairs)} bf16 leaves, {n:,} B of params: save "
            f"{save_s:.2f} s, {nbytes:,} B on disk, restore to the card {restore_s:.2f} s, "
            "bitwise equal")
        del back, pairs
    finally:
        shutil.rmtree(where, ignore_errors=True)
    log(f"[checkpoint] phase 7e wall {time.perf_counter() - t_phase:.1f} s")


def phase_first_sync_ties():
    """The first sync's top-k inputs at the embedding leaves (embed.tok, then
    embed.unembed, each for cloud 0 and 1: the first four top-k calls on a
    leaf of that size), read in a second, untimed run of the training
    phase's configuration and seed: how often the k-th magnitude of a
    256-element block is tied."""
    import torch

    import channel_cases
    from repro_torch.kernels import ops, topk_compress
    from repro_torch.launch.train import run_training

    clouds, embed_n = TRAIN["n_clouds"], 100352 * 2048
    kernel_topk = topk_compress.topk_sparsify
    ties = []

    def topk_probe(x, k):
        if x.numel() == embed_n and len(ties) < 2 * clouds:
            ties.append(channel_cases.tie_stats(x, k))
        return kernel_topk(x, k)

    topk_compress.topk_sparsify = topk_probe
    try:
        res = run_training(**TRAIN, device=DEVICE, log_fn=lambda m: None)
    finally:
        topk_compress.topk_sparsify = kernel_topk
    del res
    torch.cuda.empty_cache()
    check(len(ties) == 2 * clouds, f"the first sync's embedding leaves not seen: {len(ties)}")
    leaves = [(lf, c) for lf in ("embed.tok", "embed.unembed") for c in range(clouds)]
    for (leaf, c), st in zip(leaves, ties):
        log(f"[train] first sync (a second run), {leaf} cloud {c}, top-k input: of "
            f"{st['blocks']} blocks, k-th magnitude tied in {st['kth_tied']:.4f}, all zeros "
            f"{st['all_zero']:.4f}, fewer than {ops.topk_k(TOPK_RATIO)} nonzeros "
            f"{st['under_k_nonzero']:.4f}; rounds per block {st['rounds']:.4f}")


# ------------------------------------------------- tensor-parallel phases
# Meshes of the tensor-parallel phases: every shard on the one card.
TP_SHARDS = (2, 4)
# The counters a sharded trace must share with the unsharded one: the
# scheduler, pool and prefix index do not see the shards.
TP_COUNTERS = ("steps", "prefill_tokens", "prefill_dispatches", "cold_dispatches",
               "suffix_dispatches", "prefix_hit_pages", "cow_copies", "preemptions")


def _card_mesh(n):
    from repro_torch.launch.mesh import make_serve_mesh

    return make_serve_mesh(n, devices=[DEVICE] * n)


def _head_slice(x, dim, s, n):
    """Shard s of n of ``x`` along ``dim`` (its kv-head dim), contiguous."""
    w = x.shape[dim] // n
    return x.narrow(dim, s * w, w).contiguous()


def phase_kernels_tp(smi):
    """3e: the serving kernels at the per-shard shapes of tensor-parallel
    serving (stablelm-1.6b over 2 and 4 shards: Hkv 16 and 8, G 1, hd 64,
    bf16), on the main path's inputs of phase 3 (decode: 8 rows at depths
    100-380 over a scattered table with 6 shared pages; the suffix round: 8
    x 64 behind a 256-token shared prefix; the cold round: 8 x 512), fp and
    int8 pools. Each shard's launch is held against its plain version
    (``RTOL``) and must equal, bitwise, its heads of the Hkv-32 launch on
    the same inputs: nothing in the kernels' grids or split rule
    (``split_len(cap, hd)``) depends on the head count. Device time per
    launch at Hkv 32, 16 and 8 printed."""
    import torch

    from repro_torch.kernels import ops, ref

    gen = torch.Generator().manual_seed(31)
    b, hkv, hd, page, t_w, num_pages = 8, 32, 64, 16, 208, 209
    pos_list = [100 + 40 * r for r in range(b)]
    q, kp, vp, pos, table = _decode_case(gen, torch.bfloat16, b, hkv, 1, hd, page, t_w,
                                         num_pages, pos_list, shared=6)
    kq, ksc = ref.kv_quant_ref(kp)
    vq, vsc = ref.kv_quant_ref(vp)
    n, s_suf, start, w_pfx, s_cold = 8, 64, 256, 16, 512
    q5 = torch.randn(n, s_suf, hkv, 1, hd, generator=gen).to(DEVICE, torch.bfloat16)
    ks = torch.randn(n, s_suf, hkv, hd, generator=gen).to(DEVICE, torch.bfloat16)
    vs = torch.randn(n, s_suf, hkv, hd, generator=gen).to(DEVICE, torch.bfloat16)
    stable = _table(gen, [(start + s_suf) // page] * n, t_w, num_pages, shared=w_pfx).to(DEVICE)
    starts = torch.full((n,), start, dtype=torch.int32, device=DEVICE)
    qc = torch.randn(n, s_cold, hkv, 1, hd, generator=gen).to(DEVICE, torch.bfloat16)
    kc = torch.randn(n, s_cold, hkv, hd, generator=gen).to(DEVICE, torch.bfloat16)
    vc = torch.randn(n, s_cold, hkv, hd, generator=gen).to(DEVICE, torch.bfloat16)
    sfx = dict(prefix_width=w_pfx)
    # (name, kernel, plain version, arguments, each argument's kv-head dim
    # (None: the same for every shard), the output's kv-head dim)
    cases = (
        ("paged_decode", ops.paged_decode_attention, ref.paged_decode_ref,
         (q, kp, vp, pos, table), (1, 2, 2, None, None), 1),
        ("paged_decode_int8",
         lambda *a: ops.paged_decode_attention(*a[:5], k_scale=a[5], v_scale=a[6]),
         lambda *a: ref.paged_decode_int8_ref(a[0], a[1], a[2], a[5], a[6], a[3], a[4]),
         (q, kq, vq, pos, table, ksc, vsc), (1, 2, 2, None, None, 2, 2), 1),
        ("suffix_prefill", lambda *a: ops.suffix_prefill_attention(*a, **sfx),
         lambda *a: ref.suffix_prefill_ref(*a, **sfx),
         (q5, ks, vs, kp, vp, stable, starts), (2, 2, 2, 2, 2, None, None), 2),
        ("suffix_prefill_int8",
         lambda *a: ops.suffix_prefill_attention(*a[:7], pool_k_scale=a[7],
                                                 pool_v_scale=a[8], **sfx),
         lambda *a: ref.suffix_prefill_int8_ref(*a[:5], a[7], a[8], a[5], a[6], **sfx),
         (q5, ks, vs, kq, vq, stable, starts, ksc, vsc), (2, 2, 2, 2, 2, None, None, 2, 2), 2),
        ("flash_prefill", ops.flash_prefill_attention, ref.flash_prefill_ref,
         (qc, kc, vc), (2, 2, 2), 2),
    )
    for name, fn, plain, args, dims, out_dim in cases:
        full = fn(*args)
        times = [f"Hkv {hkv} {timed_ms(lambda: fn(*args), iters=10)[0]:.4f}"]
        for shards in TP_SHARDS:
            same, worst = True, 0.0
            for s in range(shards):
                part = [a if d is None else _head_slice(a, d, s, shards)
                        for a, d in zip(args, dims)]
                out = fn(*part)
                want = plain(*part)
                rms = want.float().pow(2).mean().sqrt().item()
                worst = max(worst, (out.float() - want.float()).abs().max().item() / rms)
                same &= torch.equal(out, _head_slice(full, out_dim, s, shards))
            check(same, f"[tp-kernels] {name} at Hkv {hkv // shards}: a shard's output is not "
                        f"bitwise its heads of the Hkv-{hkv} launch")
            expect(worst <= RTOL["bfloat16"], f"[tp-kernels] {name} at Hkv {hkv // shards}: "
                                              f"err/RMS {worst} > {RTOL['bfloat16']}")
            shard0 = [a if d is None else _head_slice(a, d, 0, shards)
                      for a, d in zip(args, dims)]
            times.append(f"Hkv {hkv // shards} {timed_ms(lambda: fn(*shard0), iters=10)[0]:.4f}")
            log(f"[tp-kernels] {name} {shards} shards (Hkv {hkv // shards}, G 1, hd {hd}, "
                f"bf16): "
                f"each shard bitwise its heads of the Hkv-{hkv} launch: {same}; vs plain, "
                f"worst err/RMS {worst:.3e} (tol {RTOL['bfloat16']:g})")
        log(f"[tp-kernels] {name} ({smi}): device ms per launch " + ", ".join(times))
        del full
    torch.cuda.empty_cache()


def phase_golden_tp():
    """4g: the reference engine's float32 golden serving traces (phase 4's
    paged trace and phase 4c's four engine runs: a windowed pool, chunked
    and interleaved rings, swa decode) served by the port on meshes of 2 and
    4 shards on the card (the smoke config's 4 heads, 2 and 1 per shard;
    graphed): tokens identical to the reference's, every kernel of the
    paths launched."""
    import torch

    from repro_torch.bridge import numpy_params, params_from_numpy
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import Request, ServeEngine
    from repro_torch.models.model import build_model

    g = json.loads((ROOT / "src/repro_torch/testdata/golden_stablelm_smoke.json").read_text())
    ring = json.loads((ROOT / "src/repro_torch/testdata/golden_stablelm_smoke_ring.json")
                      .read_text())
    cfg = dataclasses.replace(get_smoke_config("stablelm-1.6b"), dtype="float32")
    model = build_model(cfg)
    runs = [("paged", g, g["engine"], g["tokens"])]
    runs += [(r["name"], ring, r["engine"], r["tokens"]) for r in ring["runs"]]
    for shards in TP_SHARDS:
        before = dict(ops.LAUNCHES)
        names = []
        for name, src, kw, want in runs:
            params = params_from_numpy(numpy_params(cfg, src["seed"]), cfg, DEVICE)
            eng = ServeEngine(model, params, device=DEVICE, mesh=_card_mesh(shards), **kw)
            outs = eng.run([Request(uid=u, prompt=p, max_new_tokens=src["max_new_tokens"])
                            for u, p in enumerate(src["prompts"])])
            got = [o.tokens for o in outs]
            check(got == want, f"[tp-golden] {name} on {shards} shards: fp32 tokens differ "
                               f"from the reference's:\n{got}\n{want}")
            names.append(name)
        torch.cuda.synchronize()
        launched = {k: ops.LAUNCHES[k] - before[k] for k in RING_GOLDEN_KERNELS + SERVING}
        check(all(v > 0 for v in launched.values()), f"[tp-golden] {shards} shards missed a "
                                                     f"kernel: {launched}")
        log(f"[tp-golden] {shards} shards ({cfg.n_kv_heads // shards} kv heads each), "
            f"{', '.join(names)}: fp32 greedy tokens identical to the reference engine's; "
            f"kernel launches {launched}")


def _column_slices(smi, params):
    """Whether the per-shard projections round as the full ones: layer 0's
    ``wq``/``wk``/``wv`` (2048 x 2048, bf16), x @ w[:, shard] against the
    shard's columns of x @ w, at M = 8 (a decode step), 512 (a suffix round)
    and 4096 (a cold round of 8 x 512) rows, for 2 and 4 shards. Returns
    whether every slice is bitwise equal."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(17)
    d = params["layers"]["attn"]["wq"].shape[1]
    readings, equal = [], True
    for m in (8, 512, 4096):
        x = torch.randn(m, d, generator=gen, device=DEVICE).to(torch.bfloat16)
        for leaf in ("wq", "wk", "wv"):
            w = params["layers"]["attn"][leaf][0]
            full = x @ w
            for shards in TP_SHARDS:
                diffs = [((x @ _head_slice(w, 1, s, shards)).float()
                          - _head_slice(full, 1, s, shards).float()).abs().max().item()
                         for s in range(shards)]
                equal &= max(diffs) == 0
                readings.append(f"M{m} {leaf} /{shards}: {max(diffs):.3g}")
    log(f"[tp-main] {smi}: column-sliced projections vs the full product's columns (max |diff|; "
        f"0 = bitwise): " + ", ".join(readings) + f"; all bitwise: {equal}")
    return equal


def _tp_logit_parity(model, params, cfg, cold, hits, shards):
    """Phase 5's cold round over the 8 cold prompts, one decode step and the
    suffix round over the 8 shared-prefix prompts (``_parity_rounds``), at
    full width on the card: the sharded forward (per-shard params and
    pools, one process) vs the unsharded one, on the same inputs and cache
    contents. Gates the worst max |dlogit| over the logit scale at
    ``LOGIT_RTOL``; returns it and whether every stage is bitwise equal."""
    import torch

    from repro_torch.launch.engine import serving_params
    from repro_torch.launch.mesh import shard_cache, shard_params
    from repro_torch.models.model import build_model, localize_config
    from repro_torch.models.sharding import TensorAxis, use_tensor_axis

    page, n = 16, 8
    mesh = _card_mesh(shards)
    axis = TensorAxis("model", mesh.devices)
    local = build_model(localize_config(cfg, shards))
    full_p = serving_params(cfg, params)
    shard_p = shard_params(full_p, mesh)
    cache = model.init_paged_cache(n, 2 * 26 * n + 1, page, 52, device=DEVICE)
    caches = shard_cache({k: v.clone() for k, v in cache.items()}, mesh)
    r = _parity_rounds(cold, hits)

    def set_table(tab):
        for c in (cache, caches.full):   # the shards read one table tensor
            c["table"].copy_(torch.from_numpy(tab))

    worst, bitwise, msg = 0.0, True, []

    def stage(what, run):
        nonlocal worst, bitwise
        lf = run(model, full_p, cache)[1][:, : cfg.vocab_size]
        with use_tensor_axis(axis):
            ls = run(local, shard_p, caches)[1][:, : cfg.vocab_size]
        scale = max(lf.abs().max().item(), 1.0)
        d = (lf - ls).abs().max().item()
        worst, bitwise = max(worst, d / scale), bitwise and d == 0
        msg.append(f"{what} {d:.3e} = {d / scale:.3e} x scale, argmax agreement "
                   f"{(lf.argmax(-1) == ls.argmax(-1)).float().mean().item():.2f}")
        return lf

    set_table(r["table"])
    lf = stage("cold round", lambda m, p, c: m.prefill_slots(p, c, r["tokens"], r["lengths"],
                                                             r["slots"]))
    feed = lf.argmax(-1, keepdim=True).to(torch.int32)
    stage("decode step", lambda m, p, c: m.decode(p, c, feed))
    set_table(r["table_h"])
    stage("suffix round", lambda m, p, c: m.prefill_slots(
        p, c, r["stoks"], r["slens"], r["slots"], starts=r["starts"], prefix_pages=r["pw"]))
    del cache, caches, shard_p
    torch.cuda.empty_cache()
    tol = LOGIT_RTOL["bfloat16"]
    expect(worst <= tol, f"[tp-main] {shards} shards: sharded vs unsharded logits {worst} x "
                         f"scale > {tol}")
    log(f"[tp-main] {shards} shards, sharded vs unsharded forward at full width (bf16): "
        + "; ".join(msg) + f" (tol {tol:g} x scale); bitwise equal: {bitwise}")
    return worst, bitwise


def _tp_trace(model, params, main, smi, shards):
    """Phase 5's trace through a ``shards``-shard engine on the card,
    graphed, after ``warm()``: every count set to 0 just before it and read
    just after. Returns the trace's record, its launches and the engine."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.engine import ServeEngine

    eng = ServeEngine(model, params, num_slots=8, max_seq=384 + 32, page_size=16,
                      prefix_cache=True, paged_cache=True, device=DEVICE,
                      mesh=_card_mesh(shards))
    eng.warm(sorted({len(r.prompt) for r in main["cold"]}), gen_tokens=2)
    warmed = eng.compiles
    finite = []
    _tap(eng, finite)
    ops.reset_launches()
    outs, wall = _run_trace(eng, main)
    launches = dict(ops.LAUNCHES)
    eng.graphs.tap = None
    check(bool(torch.stack(finite).all()), f"[tp-main] {shards} shards: non-finite logits")
    check(eng.compiles["decode"] == 1
          and eng.compiles["prefill_slots"] == warmed["prefill_slots"],
          f"[tp-main] {shards} shards: specializations {warmed} after warm() -> {eng.compiles}")
    return _record(outs, wall, eng, launches), launches, eng


def phase_tp_main(smi, main):
    """5k-5l: tensor-parallel serving of stablelm-1.6b at its published widths
    on the one card. 5k ([tp-main]): phase 5's fp trace through engines on
    meshes of 2 and 4 shards (graphed), against the unsharded engine's
    trace: token streams, prefill tokens, dispatches and compiles; tok/s,
    TTFT p50, the decode step's device time and launches, pool bytes per
    shard. The tokens are gated identical where the per-shard projections
    round as the full ones (read first); otherwise the share of identical
    tokens is printed and the gate is the fp32 golden traces' token identity
    (4g) and the full-width logits within ``LOGIT_RTOL`` x scale of the
    unsharded forward (gated always). 5l ([tp-int8]): the int8-page trace
    of 5b on a pool tight enough to preempt, without the host tier (the
    reference refuses it under a mesh), at 2 shards against the unsharded
    engine. Returns the traces' launches."""
    import torch

    model, params, cfg = main["model"], main["params"], main["model"].cfg
    exact = _column_slices(smi, params)
    launches = {}
    base = main["record"]
    for shards in TP_SHARDS:
        _tp_logit_parity(model, params, cfg, main["cold"], main["hits"], shards)
        rec, tl, eng = _tp_trace(model, params, main, smi, shards)
        for k in SERVING:
            launches[k] = launches.get(k, 0) + tl[k]
        check(all(tl[k] > 0 for k in SERVING), f"[tp-main] {shards} shards: a kernel never "
                                               f"launched: {tl}")
        same = sum(rec["tokens"][u] == base["tokens"][u] for u in base["tokens"])
        tok_share = np.mean([a == b for u in base["tokens"]
                             for a, b in zip(rec["tokens"][u], base["tokens"][u])])
        counters = {k: (rec["counters"][k], base["counters"][k]) for k in TP_COUNTERS}
        check(all(a == b for a, b in counters.values()),
              f"[tp-main] {shards} shards: counters differ from the unsharded trace's "
              f"(sharded, unsharded): {counters}")
        check(rec["compiles"] == base["compiles"], f"[tp-main] {shards} shards: compiles "
              f"{rec['compiles']} vs unsharded {base['compiles']}")
        if exact:
            check(same == len(base["tokens"]), f"[tp-main] {shards} shards: {same} of "
                  f"{len(base['tokens'])} token streams identical to the unsharded trace's")
        per_step = _profile_decode(eng, smi, label=f"profile tp {shards} shards")
        check(per_step.get("paged_decode") == cfg.n_layers * shards,
              f"[tp-main] {shards} shards: a decode step launched {per_step} (want "
              f"{cfg.n_layers * shards} paged_decode)")
        pool = sum(t.numel() * t.element_size() for name, t in eng.cache.shards[0].items()
                   if name in ("k", "v"))
        log(f"[tp-main] {shards} shards ({smi}): {rec['tok_s']:.1f} tok/s (unsharded "
            f"{base['tok_s']:.1f}), TTFT p50 {rec['ttft'] * 1e3:.1f} ms (unsharded "
            f"{base['ttft'] * 1e3:.1f}); token streams identical to the unsharded trace's: "
            f"{same} of {len(base['tokens'])} ({tok_share:.4f} of tokens); counters "
            f"(sharded, unsharded) {counters}; compiles {rec['compiles']}; launches "
            f"{ {k: tl[k] for k in SERVING} }; pool {pool / 1e9:.4f} GB per shard "
            f"({pool * shards / 1e9:.4f} GB in all); graph pool {rec['pool']}")
        del eng
        gc.collect()
        torch.cuda.empty_cache()

    # 5l: int8 pages at 2 shards, a tight pool without the host tier
    cold, hits = _int8_path_requests(cfg.vocab_size)
    num_pages = sum(-(-len(r.prompt) // 16) for r in cold) + 4 + 1
    base_toks, base_ps, _, eng, base_rec = _serve_trace(
        model, params, cold, hits, smi, f"int8, {num_pages - 1} pages, unsharded",
        kv_dtype="int8", num_pages=num_pages)
    del eng
    gc.collect()
    toks, ps, tl, eng, rec = _serve_trace(
        model, params, cold, hits, smi, f"int8, {num_pages - 1} pages, 2 shards",
        kv_dtype="int8", num_pages=num_pages, mesh=_card_mesh(2))
    for k in SERVING_INT8:
        launches[k] = launches.get(k, 0) + tl[k]
    check(all(tl[k] > 0 for k in SERVING_INT8), f"[tp-int8] an int8 kernel never launched: "
                                                f"{tl}")
    check(ps["preemptions"] > 0, f"[tp-int8] the tight pool did not preempt: {ps}")
    counters = {k: (rec["counters"][k], base_rec["counters"][k]) for k in TP_COUNTERS}
    check(all(a == b for a, b in counters.values()), f"[tp-int8] counters differ from the "
                                                     f"unsharded trace's: {counters}")
    same = sum(toks[u] == base_toks[u] for u in base_toks)
    if exact:
        check(same == len(base_toks), f"[tp-int8] {same} of {len(base_toks)} token streams "
                                      "identical to the unsharded trace's")
    per_step = _profile_decode(eng, smi, label="profile tp int8 2 shards")
    check(per_step.get("kv_write_int8") == 2 * cfg.n_layers,
          f"[tp-int8] a decode step must write each shard's pool once per layer: {per_step}")
    log(f"[tp-int8] 2 shards ({smi}): {rec['tok_s']:.1f} tok/s (unsharded "
        f"{base_rec['tok_s']:.1f}), TTFT p50 {rec['ttft'] * 1e3:.1f} ms; token streams "
        f"identical to the unsharded trace's: {same} of {len(base_toks)}; counters (sharded, "
        f"unsharded) {counters}; launches { {k: tl[k] for k in SERVING_INT8} }")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------- phase 7f
POD_WIRE_GATE = 0.03   # the reference's own (tests/test_int8_wire.py:42)


def phase_pod_train(smi):
    """7f ([pod-train]): phase 7's load (2 clouds of stablelm-1.6b at its
    published widths, 8 x 256 tokens per cloud, H = 2, 4 steps, topk+int8
    with error feedback, DP clip and noise, fedavg) in pod mode on the one
    card (``launch/steps.make_federated_step`` over a pod mesh naming the
    card twice: the SPMD codecs, ``wire_int8``). The first sync's aggregate
    is held leaf by leaf against the dense ``weighted_average`` of the same
    transmitted updates: max error over the leaf's max magnitude <
    ``POD_WIRE_GATE``. Prints the losses, local and sync walls (the first
    sync's includes the gate's dense average), the peak memory, and the int8
    payload bytes per pod against fp32's, and one more sync's device time
    by kernel. The block channel kernels must not launch (the SPMD codecs
    are plain torch); the DP kernels must."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import aggregation as agg

    probe = {"sync": 0, "worst": 0.0, "leaves": 0, "int8": 0, "fp32": 0, "dense_leaves": 0}
    wire = agg.int8_wire_weighted_average

    def gated(stacked, weights, **kw):
        out = wire(stacked, weights, **kw)
        if probe["sync"] == 1:
            dense = agg.weighted_average([x.to(out.device) for x in stacked], weights)
            err = (out - dense).abs().max() / (dense.abs().max() + 1e-9)
            probe["worst"] = max(probe["worst"], err.item())
            probe["leaves"] += 1
            x = stacked[0]
            quantized = x.ndim > 0 and x.numel() * len(stacked) > agg.WIRE_DENSE_MAX
            rows = x.numel() // x.shape[-1] if x.ndim else 1
            probe["int8"] += len(stacked) * (x.numel() + 4 * rows if quantized
                                             else 4 * x.numel())
            probe["fp32"] += len(stacked) * 4 * x.numel()
            probe["dense_leaves"] += not quantized
        return out

    def on_sync(state, arrived):
        probe["sync"] += 1
        return None

    agg.int8_wire_weighted_average = gated
    try:
        res, walls, launches, peak, total = _timed_run("pod-train", on_sync=on_sync, pods=True,
                                                       wire_int8=True)
    finally:
        agg.int8_wire_weighted_average = wire
    losses = [x for h in res["history"] for x in h["per_cloud_loss"]]
    check(len(res["history"]) == TRAIN["steps"] and all(np.isfinite(losses)),
          f"[pod-train] non-finite losses: {losses}")
    check(probe["leaves"] > 0 and probe["worst"] < POD_WIRE_GATE,
          f"[pod-train] first sync: the int8 wire vs the dense average of the same updates, "
          f"worst leaf {probe['worst']} of its max magnitude (gate {POD_WIRE_GATE}) over "
          f"{probe['leaves']} leaves")
    check(launches["sq_norm"] > 0 and launches["clip_noise"] > 0,
          f"[pod-train] the DP kernels never launched: {launches}")
    check(launches["topk_sparsify"] == 0 and launches["int8_roundtrip"] == 0,
          f"[pod-train] the block channel kernels ran in pod mode: {launches}")
    batch, seq, clouds = TRAIN["per_cloud_batch"], TRAIN["seq_len"], TRAIN["n_clouds"]
    steady = walls["local"][1:]
    local = sum(steady) / len(steady)
    log(f"[pod-train] {smi}: {res['params']:,} parameters, {clouds} pods on one card, "
        f"{TRAIN['steps']} steps in {total:.3f} s incl. init; local step walls (both clouds) "
        f"{', '.join(f'{w * 1e3:.1f}' for w in walls['local'])} ms, steady {local * 1e3:.1f} ms "
        f"= {clouds * batch * seq / local:.0f} tokens/s; sync round walls "
        f"{', '.join(f'{w * 1e3:.1f}' for w in walls['sync'])} ms (the first holds the gate's "
        f"dense average); peak memory {peak:.2f} GB; losses {losses}; first sync: int8 wire vs "
        f"dense average, worst leaf {probe['worst']:.3e} of its max magnitude (gate "
        f"{POD_WIRE_GATE:g}) over {probe['leaves']} leaves ({probe['dense_leaves']} sent "
        f"dense); payload per sync {probe['int8']:,} B as int8 rows + fp32 scales vs "
        f"{probe['fp32']:,} B in fp32 ({probe['fp32'] / max(probe['int8'], 1):.3f}x); "
        f"launches { {k: launches[k] for k in CHANNEL} }")
    # one more sync from the trained state, profiled: its device time by kernel
    trainer, state = res["trainer"], res["state"]
    del res
    for c in state["clouds"]:
        c["opt"] = None                      # the sync reads no optimizer state
    torch.cuda.empty_cache()
    arrived = torch.ones(clouds, dtype=torch.bool, device=DEVICE)
    alphas = torch.full((clouds,), 0.5, device=DEVICE)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        trainer.__dict__["untimed_sync"](state, arrived, alphas)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    ev = _kernel_rows(prof)
    dev = sum(e.self_device_time_total for e in ev) / 1e3
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:6]
    log(f"[pod-train] {smi}: profiled sync round wall {wall:.1f} ms, device time {dev:.2f} ms "
        f"in {sum(e.count for e in ev)} kernel launches; top: "
        + "; ".join(f"{e.key[:48]} x{e.count} {e.self_device_time_total / 1e3:.2f} ms"
                    for e in top))
    del state, trainer
    gc.collect()
    torch.cuda.empty_cache()


# ----------------------------------------------------------------- phase 3f
# The attention kernels at the head dims and groups of the other configs
# ([shapes]): (label, dtype, Hkv, G, model head dim, timed). hd 160 at G 4
# over 8 kv heads is stablelm-12b's layer, hd 128 at G 3 over 8 phi4-mini's,
# G 2 at hd 32 the smoke configs' (stablelm-12b, mistral-nemo, qwen3-moe),
# and hd 30 phi4-mini's smoke layer, whose operands the kernels take padded
# to 32 with the softmax scale 30**-0.5 (``kernel_head_dim``): its plain
# version runs unpadded at 30. The timed rows are at the main path's shapes
# (8 slots at depths 100..380, page 16, scattered tables with 6 shared pages;
# the cold round 8 x 512; the hit round 8 x 64 behind a 256-token prefix;
# a decode step's and the hit round's int8 pool writes).
NEW_SHAPES = (
    ("hd160 G4 Hkv8", "bfloat16", 8, 4, 160, True),
    ("hd160 G4 Hkv8", "float32", 8, 4, 160, False),
    ("hd128 G3 Hkv8", "bfloat16", 8, 3, 128, True),
    ("hd128 G3 Hkv8", "float32", 8, 3, 128, False),
    ("hd32 G2 Hkv2", "bfloat16", 2, 2, 32, False),
    ("hd32 G2 Hkv2", "float32", 2, 2, 32, False),
    ("hd30->32 G2 Hkv2", "bfloat16", 2, 2, 30, False),
    ("hd30->32 G2 Hkv2", "float32", 2, 2, 30, False),
)


def _shape_case(smi, gen, label, dname, hkv, g, hd, timed) -> list[dict]:
    """Every attention kernel at one shape against its plain version
    (within ``RTOL`` of the plain output's RMS; the padded head dims zero),
    the bitwise contracts of the split-KV and int8 kernels, and, for a timed
    shape, each kernel's device time, wrapper wall, plain and library times
    and bound. Returns the timed rows.

    The plain versions run in float32 on the same operands (bf16 ones
    upcast, exactly), so a bf16 kernel is held to its own rounding, half an
    ulp. Both sides rounding to bf16 differ by a whole ulp wherever the two
    sums straddle a rounding boundary: over the 21 M outputs of
    ``flash_prefill`` at hd 160 / G 4 such a flip on an element several
    times the RMS read err/RMS 0.048 against the gate of 0.05 (NVIDIA H100
    80GB HBM3, 700.00 W)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.paged_decode import kernel_head_dim

    dt = getattr(torch, dname)
    khd = kernel_head_dim(hd)
    scale = hd**-0.5
    elem = dt.itemsize
    tol = RTOL[dname]
    tag = f"{label} {dname}"

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(DEVICE, dt)

    def pad(x):
        return x if khd == hd else F.pad(x, (0, khd - hd))

    def up(*xs):
        """Plain-version operands: exact float32 upcasts (see the docstring)."""
        return [x.float() for x in xs]

    def held(name, out, plain, faults=()):
        """Kernel output (cut to the model's head dim) vs the plain one."""
        cut = out[..., :hd]
        if khd != hd:
            expect(not out[..., hd:].any(), f"{name} {tag}: padded head dims not zero")
        rms = plain.float().pow(2).mean().sqrt().item()
        e = (cut.float() - plain.float()).abs().max().item()
        msg = f"[shapes] {name} {tag}: err/RMS {e / rms:.3e} (tol {tol:g})"
        expect(e <= tol * rms, f"{name} {tag}: err/RMS {e / rms} > {tol}")
        for fname, fout in faults:
            fe = (cut.float() - fout.float()).abs().max().item()
            msg += f"; planted fault '{fname}' err/RMS {fe / rms:.3e}"
            expect(fe > tol * rms, f"{name} {tag}: planted fault '{fname}' within tolerance")
        log(msg)
        return e

    # decode over the pool: 8 slots at depths 100..380, 6 shared pages
    b, page, t_w, num_pages = 8, 16, 208, 209
    pos_list = [100 + 40 * r for r in range(b)]
    q, kp, vp, pos, table = _decode_case(gen, dt, b, hkv, g, hd, page, t_w, num_pages,
                                         pos_list, shared=6)
    dec = (pad(q), pad(kp), pad(vp), pos, table)
    out = ops.paged_decode_attention(*dec, scale=scale)
    e_dec = held("paged_decode", out, ref.paged_decode_ref(*up(q, kp, vp), pos, table),
                 [("mask shifted by one", _decode_shift(*up(q, kp, vp), pos, table))])
    (kq, ks), (vq, vs) = ref.kv_quant_ref(dec[1]), ref.kv_quant_ref(dec[2])
    dec8 = (dec[0], kq, vq, pos, table)
    out8 = ops.paged_decode_attention(*dec8, k_scale=ks, v_scale=vs, scale=scale)
    kd, vd = ref.dequant_pool_ref(kq, ks, dt), ref.dequant_pool_ref(vq, vs, dt)
    same8 = torch.equal(out8, ops.paged_decode_attention(dec[0], kd, vd, pos, table,
                                                         scale=scale))
    expect(same8, f"paged_decode_int8 {tag}: not bitwise paged_decode over the dequantized pool")
    e_dec8 = held("paged_decode_int8", out8,
                  ref.paged_decode_ref(*up(q, kd[..., :hd], vd[..., :hd]), pos, table))
    alone = _rows_alone(lambda r: ops.paged_decode_attention(
        dec[0][r].contiguous(), dec[1], dec[2], pos[r].contiguous(), table[r].contiguous(),
        scale=scale), b)
    expect(alone, f"paged_decode {tag}: a row alone differs from the row in the batch")
    # the same keys as per-row rings: the ring kernels and the table kernel agree bitwise
    rk, rv = ref.gather_pages_ref(dec[1], table), ref.gather_pages_ref(dec[2], table)
    ring = ops.swa_decode_attention(dec[0], rk, rv, pos, paged=True, scale=scale)
    swa = ops.swa_decode_attention(dec[0], rk, rv, pos, paged=False, scale=scale)
    e_ring = held("paged_decode_ring", ring, ref.ring_paged_decode_ref(
        *up(q, rk[..., :hd], rv[..., :hd]), pos))
    e_swa = held("swa_decode", swa, ref.swa_decode_ref(*up(q, rk[..., :hd], rv[..., :hd]), pos))
    rings_same = torch.equal(ring, swa) and torch.equal(ring, out)
    expect(rings_same, f"{tag}: paged_decode_ring, swa_decode and paged_decode differ")
    live = [-(-(p + 1) // page) for p in pos_list]
    log(f"[shapes] decode {tag}: int8 == fp over the dequantized pool {same8}; each row alone "
        f"== its row in the batch {alone}; table == ring == swa over the same keys "
        f"{rings_same}; {_split_plan(t_w * page, dec[0].shape, [m * page for m in live])}")

    # cold prefill: 8 x 512 (timed) or a ragged 3 x 300
    n, s = (8, 512) if timed else (3, 300)
    q5, k4, v4 = rnd(n, s, hkv, g, hd), rnd(n, s, hkv, hd), rnd(n, s, hkv, hd)
    fp = (pad(q5), pad(k4), pad(v4))
    e_fp = held("flash_prefill", ops.flash_prefill_attention(*fp, scale=scale),
                ref.flash_prefill_ref(*up(q5, k4, v4)),
                [("mask shifted by one", _prefill_shift(*up(q5, k4, v4)))])
    if not timed:
        held("flash_prefill", ops.flash_prefill_attention(*fp, window=40, scale=scale),
             ref.flash_prefill_ref(*up(q5, k4, v4), window=40))

    # suffix prefill: 8 x 64 behind a 256-token prefix the rows share (W 16)
    s_suf, start, w_pfx = 64, 256, 16
    qs, ksf, vsf = rnd(b, s_suf, hkv, g, hd), rnd(b, s_suf, hkv, hd), rnd(b, s_suf, hkv, hd)
    stable = _table(gen, [(start + s_suf) // page] * b, t_w, num_pages, shared=w_pfx).to(DEVICE)
    starts = torch.full((b,), start, dtype=torch.int32, device=DEVICE)
    sp = (pad(qs), pad(ksf), pad(vsf))
    suf = ops.suffix_prefill_attention(*sp, dec[1], dec[2], stable, starts, prefix_width=w_pfx,
                                       scale=scale)
    e_suf = held("suffix_prefill", suf, ref.suffix_prefill_ref(
        *up(qs, ksf, vsf, kp, vp), stable, starts, prefix_width=w_pfx),
        [("last prefix key dropped", _suffix_shift(*up(qs, ksf, vsf, kp, vp), stable, starts,
                                                   prefix_width=w_pfx))])
    suf8 = ops.suffix_prefill_attention(*sp, kq, vq, stable, starts, prefix_width=w_pfx,
                                        pool_k_scale=ks, pool_v_scale=vs, scale=scale)
    suf_same = torch.equal(suf8, ops.suffix_prefill_attention(
        *sp, kd, vd, stable, starts, prefix_width=w_pfx, scale=scale))
    expect(suf_same, f"suffix_prefill_int8 {tag}: not bitwise suffix_prefill over the "
                     "dequantized pool")
    e_suf8 = held("suffix_prefill_int8", suf8, ref.suffix_prefill_ref(
        *up(qs, ksf, vsf, kd[..., :hd], vd[..., :hd]), stable, starts, prefix_width=w_pfx))
    log(f"[shapes] suffix {tag}: int8 == fp over the dequantized pool {suf_same}")

    # the int8 pool's writes: a decode step's (one token per row at pos) and
    # the hit round's, bitwise the plain write outside scratch page 0
    writes = [("decode step", pad(rnd(b, 1, hkv, hd)), pad(rnd(b, 1, hkv, hd)), table, pos,
               None),
              ("hit round", sp[1], sp[2], stable, starts,
               torch.full((b,), s_suf, dtype=torch.int32, device=DEVICE))]
    for what, wk, wv, wt, wst, wl in writes:
        pool = {"k": kq.clone(), "v": vq.clone(), "ks": ks.clone(), "vs": vs.clone()}
        want = {key: x.clone() for key, x in pool.items()}
        ops.kv_write_int8(pool, wk, wv, wt, wst, wl)
        ref.kv_write_int8_ref(want, wk, wv, wt, wst, wl)
        same = all(torch.equal(pool[key][1:], want[key][1:]) for key in pool)
        expect(same, f"kv_write_int8 {tag} {what}: differs from its plain version outside "
                     "page 0")
        log(f"[shapes] kv_write_int8 {tag} {what}: bitwise its plain version outside scratch "
            f"page 0: {same}")
    if not timed:
        return []

    # --- times (bf16, the main path's shapes), each beside its bound and a
    # library call computing the same function where one does
    h = hkv * g
    peak = BF16_FLOPS if dt == torch.bfloat16 else FP32_FLOPS
    spans = [p + 1 for p in pos_list]
    uniq = _unique_tokens(table, spans, page)
    kg = ref.gather_pages_ref(kp, table[:, : max(live)]).transpose(1, 2)
    vg = ref.gather_pages_ref(vp, table[:, : max(live)]).transpose(1, 2)
    dmask = (torch.arange(max(live) * page, device=DEVICE)[None, :]
             <= pos[:, None].long())[:, None, None, :]
    qd = q.reshape(b, h, 1, hd)
    # the rings hold the table's keys in position order (no wrap at this
    # capacity): the library call reads their live span in place
    rkl = rk[:, : max(live) * page].transpose(1, 2)
    rvl = rv[:, : max(live) * page].transpose(1, 2)
    kdg = ref.gather_pages_ref(kd[..., :hd], table[:, : max(live)]).transpose(1, 2)
    vdg = ref.gather_pages_ref(vd[..., :hd], table[:, : max(live)]).transpose(1, 2)
    dec_bytes = 2 * b * h * hd * elem + 4 * (b + sum(live))
    dec_flops = 4 * sum(spans) * h * hd
    qf = q5.reshape(n, s, h, hd).transpose(1, 2)
    kf, vf = k4.transpose(1, 2), v4.transpose(1, 2)
    pp = start // page
    suniq = _unique_tokens(stable, [start] * b, page)
    kc = torch.cat([ref.gather_pages_ref(kp, stable[:, :w_pfx]), ksf], 1).transpose(1, 2)
    vc = torch.cat([ref.gather_pages_ref(vp, stable[:, :w_pfx]), vsf], 1).transpose(1, 2)
    kc8 = torch.cat([ref.gather_pages_ref(kd, stable[:, :w_pfx]), ksf], 1).transpose(1, 2)
    vc8 = torch.cat([ref.gather_pages_ref(vd, stable[:, :w_pfx]), vsf], 1).transpose(1, 2)
    smask = (torch.arange(start + s_suf, device=DEVICE)[None, :]
             <= start + torch.arange(s_suf, device=DEVICE)[:, None])
    qst = qs.reshape(b, s_suf, h, hd).transpose(1, 2)
    # q and out, the suffix k/v, starts and the prefix table entries
    suf_bytes = 2 * b * s_suf * (h + hkv) * hd * elem + 4 * b * (1 + pp)
    suf_flops = 4 * b * h * hd * (s_suf * start + s_suf * (s_suf + 1) // 2)
    wk, wv, wt, wst, _ = writes[0][1:]
    wpool = {"k": kq.clone(), "v": vq.clone(), "ks": ks.clone(), "vs": vs.clone()}

    def sdpa(qq, kk, vv, **kw):
        return F.scaled_dot_product_attention(qq, kk, vv, enable_gqa=True, **kw)

    cases = [
        ("paged_decode", e_dec, lambda: ops.paged_decode_attention(*dec, scale=scale),
         lambda: ref.paged_decode_ref(*dec), lambda: sdpa(qd, kg, vg, attn_mask=dmask),
         dec_bytes + 2 * uniq * hkv * hd * elem, dec_flops),
        ("paged_decode_int8", e_dec8,
         lambda: ops.paged_decode_attention(*dec8, k_scale=ks, v_scale=vs, scale=scale),
         lambda: ref.paged_decode_int8_ref(dec[0], kq, vq, ks, vs, pos, table),
         lambda: sdpa(qd, kdg, vdg, attn_mask=dmask),
         dec_bytes + 2 * uniq * hkv * (hd + 4), dec_flops),
        ("paged_decode_ring", e_ring,
         lambda: ops.swa_decode_attention(dec[0], rk, rv, pos, paged=True, scale=scale),
         lambda: ref.ring_paged_decode_ref(dec[0], rk, rv, pos),
         lambda: sdpa(qd, rkl, rvl, attn_mask=dmask),
         2 * b * h * hd * elem + 2 * sum(spans) * hkv * hd * elem + 4 * b, dec_flops),
        ("swa_decode", e_swa,
         lambda: ops.swa_decode_attention(dec[0], rk, rv, pos, paged=False, scale=scale),
         lambda: ref.swa_decode_ref(dec[0], rk, rv, pos),
         lambda: sdpa(qd, rkl, rvl, attn_mask=dmask),
         2 * b * h * hd * elem + 2 * sum(spans) * hkv * hd * elem + 4 * b, dec_flops),
        ("flash_prefill", e_fp, lambda: ops.flash_prefill_attention(*fp, scale=scale),
         lambda: ref.flash_prefill_ref(*fp), lambda: sdpa(qf, kf, vf, is_causal=True),
         (2 * n * s * h * hd + 2 * n * s * hkv * hd) * elem,
         4 * n * h * hd * s * (s + 1) // 2),
        ("suffix_prefill", e_suf,
         lambda: ops.suffix_prefill_attention(*sp, dec[1], dec[2], stable, starts,
                                              prefix_width=w_pfx, scale=scale),
         lambda: ref.suffix_prefill_ref(*sp, dec[1], dec[2], stable, starts,
                                        prefix_width=w_pfx),
         lambda: sdpa(qst, kc, vc, attn_mask=smask),
         suf_bytes + 2 * suniq * hkv * hd * elem, suf_flops),
        ("suffix_prefill_int8", e_suf8,
         lambda: ops.suffix_prefill_attention(*sp, kq, vq, stable, starts, prefix_width=w_pfx,
                                              pool_k_scale=ks, pool_v_scale=vs, scale=scale),
         lambda: ref.suffix_prefill_int8_ref(*sp, kq, vq, ks, vs, stable, starts,
                                             prefix_width=w_pfx),
         lambda: sdpa(qst, kc8, vc8, attn_mask=smask),
         suf_bytes + 2 * suniq * hkv * (hd + 4), suf_flops),
        ("kv_write_int8", 0.0, lambda: ops.kv_write_int8(wpool, wk, wv, wt, wst),
         lambda: ref.kv_write_int8_ref(wpool, wk, wv, wt, wst), None,
         2 * b * hkv * hd * elem + 2 * b * hkv * (hd + 4) + 4 * b * 2, 0),
    ]
    rows = []
    for name, err, kern, plain, lib, nbytes, flops in cases:
        ms, wall = timed_ms(kern)
        t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
        row = dict(name=name, shape=tag, max_abs_err=err, ms=ms, wrapper_ms=wall,
                   plain_ms=timed_ms(plain, iters=5)[0],
                   library_ms=None if lib is None else timed_ms(lib)[0],
                   bound_ms=max(t_b, t_o), bound_by="bytes" if t_b >= t_o else "operations")
        rows.append(row)
        lib_s = "none" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
        log(f"[shapes] {name} {tag} ({smi}): kernel device ms {ms:.4f} (wrapper wall "
            f"{wall:.4f}) plain_ms {row['plain_ms']:.4f} library_ms {lib_s} bound_ms "
            f"{row['bound_ms']:.4f} ({row['bound_by']}: {nbytes / 1e6:.2f} MB, "
            f"{flops / 1e9:.3f} GFLOP)")
    return rows


def phase_kernels_shapes(smi) -> list[dict]:
    """3f: ``NEW_SHAPES``, every attention kernel (``_shape_case``)."""
    import torch

    gen = torch.Generator().manual_seed(27)
    rows = []
    for case in NEW_SHAPES:
        rows += _shape_case(smi, gen, *case)
        torch.cuda.empty_cache()
    return rows


# ----------------------------------------------------------------- phase 3g
# recurrentgemma-2b's local attention: hd 256, 10 query heads over 1 kv head,
# window 2048. The cold prefill at a 4 x 4096 prompt (the ring wraps at
# 2048), the decode kernels over 8 rings of 2048 slots, rows at depths short
# of the ring and wrapped up to four times.
HD256 = dict(hkv=1, g=10, hd=256, window=2048)
HD256_PREFILL = dict(b=4, s=4096)
HD256_RING = dict(b=8, cap=2048, pos=(100, 1000, 2047, 2048, 3000, 4095, 5000, 8500))


def _flip_gated(out, exact, dt):
    """(err/RMS beyond one-ulp flips, raw err/RMS, raw max abs err) of a
    kernel output against the exact float32 plain output: in bf16 an
    element where the kernel's output and the plain output rounded to bf16
    are adjacent bf16 numbers is a rounding flip (two roundings of nearly
    equal fp32 values) and is left out of the gated error, as in phase 3's
    ring cold round; in float32 every element counts."""
    import torch

    rms = exact.pow(2).mean().sqrt().item()
    diff = (out.float() - exact).abs()
    raw = diff.max().item()
    if dt != torch.bfloat16:
        return raw / rms, raw / rms, raw
    plain = exact.to(torch.bfloat16)
    ulps = (out.view(torch.int16).int() - plain.view(torch.int16).int()).abs()
    beyond = diff[ulps > 1]
    return (beyond.max().item() / rms if beyond.numel() else 0.0), raw / rms, raw


def phase_kernels_hd256(smi) -> list[dict]:
    """3g ([hd256]): ``flash_prefill`` (B 4, S 4096, window 2048),
    ``paged_decode_ring`` and ``swa_decode`` (B 8, C 2048, window 2048, rows
    short of the ring and wrapped) at hd 256, G 10, Hkv 1, in bf16 and
    float32, each against its plain version within ``RTOL`` (bf16 prefill:
    one-ulp flips left out, ``_flip_gated``), the two ring kernels bitwise
    equal; planted faults (the prefill's mask shifted by one, the decode
    mask shifted by one key, without the mod wrap, the last live page
    dropped) outside it. bf16 is timed: device ms, wrapper wall, the plain
    version's ms, SDPA with ``enable_gqa`` over the same keys, and the
    bound (live (query, key) pairs; live keys read once). Returns the
    timed rows."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    c, cp, cr = HD256, HD256_PREFILL, HD256_RING
    hkv, g, hd, w = c["hkv"], c["g"], c["hd"], c["window"]
    h = hkv * g
    gen = torch.Generator().manual_seed(28)
    rows, timed = [], []
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        tol = RTOL[dname]
        tag = f"hd{hd} G{g} Hkv{hkv} {dname}"
        elem = dt.itemsize

        def rnd(*shape):
            return torch.randn(*shape, generator=gen).to(DEVICE, dt)

        # --- cold prefill
        b, s = cp["b"], cp["s"]
        q5, k4, v4 = rnd(b, s, hkv, g, hd), rnd(b, s, hkv, hd), rnd(b, s, hkv, hd)
        out = ops.flash_prefill_attention(q5, k4, v4, window=w)
        torch.cuda.synchronize()
        exact = ref.flash_prefill_ref(q5.float(), k4.float(), v4.float(), window=w)
        e_fp, raw, e_abs = _flip_gated(out, exact, dt)
        expect(e_fp <= tol, f"flash_prefill {tag}: err/RMS {e_fp} > {tol}")
        rms = exact.pow(2).mean().sqrt().item()
        fault = _prefill_shift(q5.float(), k4.float(), v4.float(), window=w)
        fe = (out.float() - fault).abs().max().item() / rms
        expect(fe > tol, f"flash_prefill {tag}: planted fault 'mask shifted by one' within "
                         "tolerance")
        log(f"[hd256] flash_prefill {tag} B{b} S{s} window {w}: err/RMS {e_fp:.3e}"
            + (f" beyond one-ulp flips ({raw:.3e} with them)" if dt == torch.bfloat16 else "")
            + f" (tol {tol:g}); planted fault 'mask shifted by one' err/RMS {fe:.3e}")
        del exact, fault
        torch.cuda.empty_cache()
        if dt == torch.bfloat16:
            pairs = sum(min(i + 1, w) for i in range(s))
            qt = q5.reshape(b, s, h, hd).transpose(1, 2)
            kt, vt = k4.transpose(1, 2), v4.transpose(1, 2)
            pp = torch.arange(s, device=DEVICE)
            wmask = (pp[None, :] <= pp[:, None]) & (pp[:, None] - pp[None, :] < w)
            rows.append(dict(
                name="flash_prefill", max_abs_err=e_abs, err=e_fp,
                kern=lambda: ops.flash_prefill_attention(q5, k4, v4, window=w),
                plain=lambda: ref.flash_prefill_ref(q5, k4, v4, window=w),
                lib=lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=wmask,
                                                          enable_gqa=True),
                nbytes=(2 * b * s * h * hd + 2 * b * s * hkv * hd) * elem,
                flops=4 * b * h * hd * pairs, shape=f"{tag} B{b} S{s} window {w}"))

        # --- ring decode
        b, cap = cr["b"], cr["cap"]
        q = rnd(b, hkv, g, hd)
        rk, rv = rnd(b, cap, hkv, hd), rnd(b, cap, hkv, hd)
        pos = torch.tensor(cr["pos"], dtype=torch.int32, device=DEVICE)
        ring = ops.swa_decode_attention(q, rk, rv, pos, w, paged=True)
        swa = ops.swa_decode_attention(q, rk, rv, pos, w, paged=False)
        same = torch.equal(ring, swa)
        expect(same, f"{tag}: paged_decode_ring and swa_decode differ")
        exact = _ring_plain(q.float(), rk.float(), rv.float(), pos, w).float()
        rms = exact.pow(2).mean().sqrt().item()
        msg = f"[hd256] ring decode {tag} B{b} C{cap} window {w} pos {list(cr['pos'])}: " \
              f"paged_decode_ring == swa_decode bitwise {same}"
        for name, o in (("paged_decode_ring", ring), ("swa_decode", swa)):
            e = (o.float() - exact).abs().max().item()
            expect(e <= tol * rms, f"{name} {tag}: err/RMS {e / rms} > {tol}")
            msg += f"; {name} err/RMS {e / rms:.3e}"
        for fname, kind in RING_FAULTS:
            fault = _ring_plain(q.float(), rk.float(), rv.float(), pos, w, fault=kind)
            fe = (ring.float() - fault.float()).abs().max().item() / rms
            expect(fe > tol, f"paged_decode_ring {tag}: planted fault '{fname}' within "
                             "tolerance")
            msg += f"; planted fault '{fname}' err/RMS {fe:.3e}"
        log(msg + f" (tol {tol:g}); {_split_plan(cap, q.shape, [cap] * b)}")
        if dt == torch.bfloat16:
            ku, vu, kmask, spans = _unrolled(rk, rv, pos, w)
            qd = q.reshape(b, h, 1, hd)
            nbytes = 2 * b * h * hd * elem + 2 * sum(spans) * hkv * hd * elem + 4 * b
            for name, paged in (("paged_decode_ring", True), ("swa_decode", False)):
                e = (ring if paged else swa).float().sub(exact).abs().max().item()
                rows.append(dict(
                    name=name, max_abs_err=e, err=e / rms,
                    kern=lambda paged=paged: ops.swa_decode_attention(q, rk, rv, pos, w,
                                                                       paged=paged),
                    plain=lambda paged=paged: (ref.ring_paged_decode_ref if paged else
                                               ref.swa_decode_ref)(q, rk, rv, pos, w),
                    lib=lambda: F.scaled_dot_product_attention(
                        qd, ku, vu, attn_mask=kmask[:, None, None, :], enable_gqa=True),
                    nbytes=nbytes, flops=4 * sum(spans) * h * hd,
                    shape=f"{tag} B{b} C{cap} window {w}"))
            # timed now, while the closures' operands are this dtype's
            timed += [_hd256_timed(smi, r) for r in rows]
            rows.clear()
        del q, rk, rv, ring, swa, exact, q5, k4, v4, out
        torch.cuda.empty_cache()
    return timed


def _hd256_timed(smi, r: dict, tag: str = "hd256") -> dict:
    """One timed row of phase 3g (3w-3x, 5w: ``tag`` "whisper-kernels"):
    device and wrapper ms of the kernel, the plain version's and SDPA's
    device ms, the bound."""
    ms, wall = timed_ms(r["kern"])
    t_b, t_o = r["nbytes"] / HBM_BYTES_PER_S * 1e3, r["flops"] / BF16_FLOPS * 1e3
    row = dict(name=r["name"], shape=r["shape"], max_abs_err=r["max_abs_err"], ms=ms,
               wrapper_ms=wall, plain_ms=timed_ms(r["plain"], iters=3)[0],
               library_ms=timed_ms(r["lib"])[0], bound_ms=max(t_b, t_o),
               bound_by="bytes" if t_b >= t_o else "operations")
    log(f"[{tag}] {r['name']} {r['shape']} ({smi}): kernel device ms {ms:.4f} (wrapper "
        f"wall {wall:.4f}) plain_ms {row['plain_ms']:.4f} library_ms "
        f"{row['library_ms']:.4f} ({r.get('lib_what', 'SDPA, enable_gqa')}) bound_ms "
        f"{row['bound_ms']:.4f} "
        f"({row['bound_by']}: {r['nbytes'] / 1e6:.2f} MB, {r['flops'] / 1e9:.3f} GFLOP); "
        f"err/RMS {r['err']:.3e}")
    return row


# ----------------------------------------------------------------- phase 4h
# The reference engine's float32 traces of the other configs (written by
# tests/test_torch_dense_configs.py and tests/test_torch_moe.py).
CONFIG_GOLDENS = (("stablelm-12b", "golden_stablelm12b_smoke.json"),
                  ("mistral-nemo-12b", "golden_mistral_nemo_smoke.json"),
                  ("phi4-mini-3.8b", "golden_phi4_mini_smoke.json"),
                  ("olmoe-1b-7b", "golden_olmoe_smoke.json"))


def phase_golden_configs():
    """4h: each golden trace replayed on the card through CUDA graphs in
    float32: greedy tokens and pool counters identical, every serving
    kernel launched."""
    import torch

    from repro_torch.bridge import numpy_params, params_from_numpy
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import Request, ServeEngine
    from repro_torch.models.model import build_model

    for arch, fname in CONFIG_GOLDENS:
        g = json.loads((ROOT / "src/repro_torch/testdata" / fname).read_text())
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        params = params_from_numpy(numpy_params(cfg, g["seed"]), cfg, DEVICE)
        eng = ServeEngine(build_model(cfg), params, device=DEVICE, **g["engine"])
        ops.reset_launches()
        outs = eng.run([Request(uid=u, prompt=np.asarray(p, np.int32),
                                max_new_tokens=g["max_new_tokens"])
                        for u, p in enumerate(g["prompts"])])
        torch.cuda.synchronize()
        launched = {k: ops.LAUNCHES[k] for k in SERVING}
        got = [o.tokens for o in outs]
        counters = {k: eng.pool_stats[k] for k in g["counters"]}
        check(got == g["tokens"], f"golden {arch}: fp32 tokens differ from the reference:\n"
                                  f"{got}\n{g['tokens']}")
        check(counters == g["counters"], f"golden {arch}: counters {counters} vs "
                                         f"{g['counters']}")
        check(all(v > 0 for v in launched.values()), f"golden {arch} missed a kernel: {launched}")
        log(f"[golden-configs] {arch} (hd {cfg.resolved_head_dim}, kernel hd "
            f"{eng.cache['k'].shape[-1]}, G {cfg.n_heads // cfg.n_kv_heads}, {cfg.arch_type}): "
            f"{len(got)} requests, fp32 greedy tokens and counters identical to the reference "
            f"engine's {counters}; kernel launches {launched}")
        del eng, params
    gc.collect()
    torch.cuda.empty_cache()


# ----------------------------------------------------------------- phase 5m
# The other configs at their published widths, one model on the card at a
# time, bf16, random weights from a torch.Generator: (arch, kv dtypes).
CONFIG_MAINS = (("stablelm-12b", ("fp", "int8")), ("phi4-mini-3.8b", ("fp",)),
                ("mistral-nemo-12b", ("fp",)), ("olmoe-1b-7b", ("fp",)))
# The float32 logit parity's weights: a copy of every layer where bf16 + fp32
# (6 bytes a parameter) stay under FP32_COPY_BYTES, else of the first
# FP32_LAYERS layers (the 12 B configs: 73 GB at full depth).
FP32_COPY_BYTES = 50e9
FP32_LAYERS = 8


def _first_layers(params: dict, depth: int) -> dict:
    """``params`` with the stacked per-layer leaves cut to their first
    ``depth`` layers (views)."""
    return {**params, "layers": {name: {leaf: t[:depth] for leaf, t in group.items()}
                                 for name, group in params["layers"].items()}}


def phase_configs_main(smi) -> dict:
    """5m ([configs-main]): each of ``CONFIG_MAINS`` at its published widths
    (nothing cut): the cold round, a decode step and the suffix round
    through the kernels against the plain versions (bf16 logits within
    0.1 x scale, 0.03 for an MoE model, planted faults outside; on int8
    pages too where listed;
    float32 within 1e-3 x scale, over ``FP32_LAYERS`` layers where a
    float32 copy of every layer would not fit),
    then phase 5's trace (8 slots, page 16, 8 cold prompts, then 8 sharing a
    256-token prefix, 32 greedy tokens each) through CUDA graphs: every
    request's budget, finite logits, every serving kernel launched; tok/s,
    TTFT p50, the decode step's device time and launches, the pool's bytes
    per token. Returns the kernels' launches over the traces."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model

    total = {k: 0 for k in ops.LAUNCHES}
    for arch, kv_dtypes in CONFIG_MAINS:
        t0 = time.perf_counter()
        cfg = get_config(arch)
        model = build_model(cfg)
        torch.cuda.reset_peak_memory_stats()
        params = model.init(torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
        log(f"[configs-main] {arch}: {cfg.arch_type}, {cfg.n_layers} layers, d {cfg.d_model}, "
            f"{cfg.n_heads}/{cfg.n_kv_heads} heads (G {cfg.n_heads // cfg.n_kv_heads}), hd "
            f"{cfg.resolved_head_dim}, vocab {cfg.vocab_size}, rope theta {cfg.rope_theta:g}"
            + (f", {cfg.n_experts} experts top {cfg.experts_per_token}" if cfg.n_experts else "")
            + f", tied {cfg.tie_embeddings}, {cfg.dtype}: {_numel(params) / 1e9:.2f} B "
            f"parameters, {_nbytes(params) / 1e9:.1f} GB")
        cold, hits = _main_path_requests(cfg.vocab_size)
        # float32 parity from a copy of the weights: every layer where the
        # copy fits beside the bf16 weights, else the first FP32_LAYERS
        depth = cfg.n_layers if 6 * _numel(params) < FP32_COPY_BYTES else FP32_LAYERS
        cfg32 = dataclasses.replace(cfg, dtype="float32", n_layers=depth)
        params32 = _cast(_first_layers(params, depth), torch.float32)
        log(f"[configs-main] {arch}: float32 parity over {depth} of {cfg.n_layers} layers"
            + ("" if depth == cfg.n_layers else
               f" (cut: a float32 copy of every layer, {4 * _numel(params) / 1e9:.1f} GB, "
               f"beside the {_nbytes(params) / 1e9:.1f} GB of bf16 weights passes "
               f"{FP32_COPY_BYTES / 1e9:.0f} GB)"))
        _logit_parity(build_model(cfg32), params32, cfg32, cold, hits)
        del params32
        torch.cuda.empty_cache()
        for kv in kv_dtypes:
            _logit_parity(model, params, cfg, cold, hits, kv_dtype=kv)
            serving = SERVING if kv == "fp" else SERVING_INT8
            _, ps, launches, eng, rec = _serve_trace(model, params, cold, hits, smi,
                                                     f"{arch} {kv} pages", tag="configs-main",
                                                     kv_dtype=kv)
            check(all(len(t) == 32 for t in rec["tokens"].values()) and len(rec["tokens"]) == 16,
                  f"{arch} {kv}: not every request finished with 32 tokens")
            check(ps["suffix_dispatches"] > 0 and ps["cold_dispatches"] > 0,
                  f"{arch} {kv}: dispatch split not exercised: {ps}")
            check(all(launches[k] > 0 for k in serving),
                  f"{arch} {kv}: a serving kernel never launched: {launches}")
            for k in total:
                total[k] += launches[k]
            per_step = _profile_decode(eng, smi, label=f"configs-main profile {arch} {kv}")
            log(f"[configs-main] {arch} {kv} pages ({smi}): tok/s {rec['tok_s']:.1f}, TTFT "
                f"p50 {rec['ttft'] * 1e3:.1f} ms, pool {ps['kv_bytes_per_token']} bytes per "
                f"token (kernel hd {eng.cache['k'].shape[-1]}), launches "
                f"{ {k: launches[k] for k in serving} }, per decode step {per_step}")
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        log(f"[configs-main] {arch}: peak device memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB; wall "
            f"{time.perf_counter() - t0:.1f} s")
        del params, model
        gc.collect()
        torch.cuda.empty_cache()
    return total


# ----------------------------------------------------------------- phase 4i
# The reference's float32 golden traces of the recurrent families (written
# by tests/test_torch_rglru.py, tests/test_torch_xlstm.py and
# tests/test_torch_recurrent_train.py).
GOLDEN_RECURRENT_SERVE = "golden_recurrent_serve_smoke.json"
GOLDEN_XLSTM_DRAFT = "golden_xlstm_draft_smoke.json"
GOLDEN_TRAIN_RECURRENT = "golden_train_recurrent_smoke.json"


def phase_golden_recurrent():
    """4i ([golden-recurrent]): the recurrent families' golden traces on the
    card in float32: the single-batch tokens of xlstm-125m and of
    recurrentgemma-2b (window 8, the 12-token prompts wrap the ring) through
    ``generate_batch``'s decode graph, the hybrid's through ``swa_decode``;
    the engine trace of the stablelm-1.6b smoke target with an xlstm-125m
    draft through CUDA graphs (tokens and counters identical, the target's
    serving kernels launched); both families' FedAvg training
    (``golden_train``: per-cloud losses within ``GOLDEN_TRAIN_RTOL``,
    checksums within ``GOLDEN_TRAIN_SUM_TOL``, the channel kernels
    launched). Returns the launches of the three replays."""
    import torch

    import golden_train
    from repro_torch.bridge import numpy_params, params_from_numpy
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import Request, ServeEngine
    from repro_torch.launch.graphs import GraphCache
    from repro_torch.launch.serve import generate_batch
    from repro_torch.models.model import build_model

    data = ROOT / "src/repro_torch/testdata"
    total = {k: 0 for k in ops.LAUNCHES}

    def smoke32(arch, seed):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        return build_model(cfg), params_from_numpy(numpy_params(cfg, seed), cfg, DEVICE)

    def tally(what):
        torch.cuda.synchronize()
        launched = {k: v for k, v in ops.LAUNCHES.items() if v}
        for k, v in launched.items():
            total[k] += v
        return launched

    g = json.loads((data / GOLDEN_RECURRENT_SERVE).read_text())
    for case in g["cases"]:
        model, params = smoke32(case["arch"], g["seed"])
        graphs = GraphCache(DEVICE)
        ops.reset_launches()
        gen, _, _ = generate_batch(model, params, torch.tensor(case["prompts"], device=DEVICE),
                                   case["gen"], window=case["window"], graphs=graphs)
        launched = tally(case["arch"])
        check(gen.tolist() == case["tokens"], f"golden single batch {case['arch']}: fp32 tokens "
                                              f"differ from the reference's")
        if model.cfg.arch_type == "hybrid":
            check(launched.get("swa_decode", 0) > 0, f"golden single batch {case['arch']}: "
                                                     f"swa_decode never launched: {launched}")
        log(f"[golden-recurrent] single batch {case['arch']} window {case['window']}: "
            f"{len(case['prompts'])} x {len(case['prompts'][0])} + {case['gen']}, fp32 greedy "
            f"tokens identical to the reference's; compiles {graphs.counts}; launches {launched}")

    g = json.loads((data / GOLDEN_XLSTM_DRAFT).read_text())
    target, tparams = smoke32("stablelm-1.6b", g["seed"])
    draft, dparams = smoke32("xlstm-125m", g["draft_seed"])
    eng = ServeEngine(target, tparams, device=DEVICE, draft_model=draft, draft_params=dparams,
                      spec_tokens=g["spec_tokens"], **g["engine"])
    ops.reset_launches()
    outs = eng.run([Request(uid=u, prompt=np.asarray(p, np.int32),
                            max_new_tokens=g["max_new_tokens"])
                    for u, p in enumerate(g["prompts"])])
    launched = tally("draft")
    counters = {k: eng.pool_stats[k] for k in g["counters"]}
    check([o.tokens for o in outs] == g["tokens"], "golden xlstm draft: fp32 tokens differ from "
                                                   "the reference engine's")
    check(counters == g["counters"], f"golden xlstm draft: counters {counters} vs "
                                     f"{g['counters']}")
    check(type(eng.draft).__name__ == "XlstmDraft", "golden xlstm draft: not the recurrent draft")
    check(all(launched.get(k, 0) > 0 for k in ("flash_prefill", "suffix_prefill")),
          f"golden xlstm draft: a target kernel never launched: {launched}")
    log(f"[golden-recurrent] {g['config']}, k {g['spec_tokens']}: {len(outs)} requests, fp32 "
        f"greedy tokens and counters identical to the reference engine's {counters}; compiles "
        f"{dict(eng.graphs.counts)}; launches {launched}")
    del eng, target, tparams, draft, dparams

    g = json.loads((data / GOLDEN_TRAIN_RECURRENT).read_text())
    for arch, case in g.items():
        ops.reset_launches()
        got = golden_train.golden_train_replay(case, "fedavg", DEVICE)
        launched = tally(arch)
        loss, sums = golden_train.golden_train_errors(case["cases"]["fedavg"], got)
        check(loss <= golden_train.GOLDEN_TRAIN_RTOL,
              f"golden training {arch}: loss rel err {loss} > {golden_train.GOLDEN_TRAIN_RTOL}")
        check(sums <= golden_train.GOLDEN_TRAIN_SUM_TOL,
              f"golden training {arch}: checksum err {sums} > {golden_train.GOLDEN_TRAIN_SUM_TOL}")
        check(all(launched.get(k, 0) > 0 for k in CHANNEL),
              f"golden training {arch}: a channel kernel never launched: {launched}")
        log(f"[golden-recurrent] training {arch} fedavg {case['fed']['compression']} DP clip "
            f"{case['fed']['dp_clip']}: {len(got['losses'])} steps, largest loss rel err "
            f"{loss:.3e} (tol {golden_train.GOLDEN_TRAIN_RTOL:g}), checksum err {sums:.3e} (tol "
            f"{golden_train.GOLDEN_TRAIN_SUM_TOL:g}); launches {launched}")
    gc.collect()
    torch.cuda.empty_cache()
    return total


# ----------------------------------------------------------------- phase 5n
# recurrentgemma-2b's main path at full width: the single batch (4 x 64 + 64,
# window 96), a 4 x 4096 prefill (the rings of 2048 wrap) and 32 decode steps.
RG_MAIN = dict(arch="recurrentgemma-2b", batch=4, prompt=4096, steps=32, serve=(64, 64, 96))
XLSTM_MAIN = dict(arch="xlstm-125m", batch=4, prompt=512, steps=8, serve=(64, 64, 0))


def _recurrent_serve(smi, model, params, tag, prompt, gen, window) -> dict:
    """The single batch at full width through its decode graph: (launches)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.engine import synthetic_prompts
    from repro_torch.launch.graphs import GraphCache
    from repro_torch.launch.serve import generate_batch

    cfg = model.cfg
    prompts = torch.from_numpy(synthetic_prompts(cfg, 4, prompt, 0)).to(DEVICE)
    graphs = GraphCache(DEVICE)
    torch.cuda.synchronize()
    ops.reset_launches()
    gen_toks, t_prefill, t_gen = generate_batch(model, params, prompts, gen, window=window,
                                                graphs=graphs)
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    check(gen_toks.shape == (4, gen) and bool(((gen_toks >= 0)
                                               & (gen_toks < cfg.vocab_size)).all()),
          f"{cfg.name} single batch: output {tuple(gen_toks.shape)} out of range")
    check(graphs.counts == {"decode": 1}, f"{cfg.name} single batch: compiles {graphs.counts}")
    log(f"[{tag}] {cfg.name} single batch ({smi}): 4 x {prompt} teacher-forced in "
        f"{t_prefill:.3f} s, {gen} tokens/row in {t_gen:.3f} s: {4 * gen / t_gen:.1f} tok/s; "
        f"window {window}; launches {launches}; compiles {graphs.counts}; graph pool "
        f"{graphs.pool_bytes() / 1e9:.3f} GB")
    return launches


def _recurrent_parity(smi, model, params, tag, prompts, feeds, faults=(), inputs=None,
                      cache_window=0) -> dict:
    """``prefill`` of ``prompts`` (with the batch's other ``inputs``: patch
    or audio embeddings) into rings of ``cache_window`` slots (0: the
    model's default), then teacher-forced decode steps of ``feeds``
    through the kernels (timed; paged_decode_ring), then through the plain
    versions and each planted fault: the logits of every dispatch within
    ``LOGIT_RTOL`` x scale, the faults outside. Returns the kernel run's
    launches."""
    import torch

    from repro_torch.kernels import ops

    cfg = model.cfg
    vocab = cfg.vocab_size
    walls = {}

    def run(timed=False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache, lg = model.prefill(params, {"tokens": prompts, **(inputs or {})},
                                  cache_window=cache_window)
        torch.cuda.synchronize()
        walls["prefill"] = time.perf_counter() - t0
        out = [lg[:, :vocab].float()]
        t0 = time.perf_counter()
        for t in range(feeds.shape[1]):
            cache, lg = model.decode(params, cache, feeds[:, t:t + 1])
            out.append(lg[:, :vocab].float())
        torch.cuda.synchronize()
        walls["decode"] = (time.perf_counter() - t0) / max(feeds.shape[1], 1)
        del cache
        return torch.stack(out, 1)

    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    lk = run()
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated() / 1e9
    kern_walls = dict(walls)
    check(bool(torch.isfinite(lk).all()), f"{cfg.name} {cfg.dtype}: non-finite logits")
    with plain_kernels():
        lp = run()
    tol = LOGIT_RTOL[cfg.dtype]
    scale = max(lp.abs().max().item(), 1.0)
    d = (lk - lp).abs().amax(dim=(0, 2))          # per dispatch
    agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
    msg = (f"[{tag}] {cfg.name} {cfg.dtype} ({smi}): B{prompts.shape[0]} prefill "
           f"{prompts.shape[1]} + {feeds.shape[1]} decode steps, kernels vs plain max |dlogit| "
           f"prefill {d[0].item():.3e}, decode steps {d[1:].max().item() if len(d) > 1 else 0:.3e}"
           f" = {d.max().item() / scale:.3e} x logit scale {scale:.2f} (tol {tol:g} x scale), "
           f"argmax agreement {agree:.3f}")
    expect(d.max().item() <= tol * scale, f"{cfg.name} {cfg.dtype}: logit diff {d.max().item()} "
                                          f"> {tol} x {scale}")
    for fname, swap in faults:
        with plain_kernels(**swap):
            lf = run()
        fd = (lk - lf).abs().max().item()
        msg += f"; planted fault '{fname}' {fd:.3e} = {fd / scale:.3e} x scale"
        expect(fd > tol * scale, f"{cfg.name} {cfg.dtype}: planted fault '{fname}' within "
                                 "tolerance")
        del lf
    log(msg + f"; kernel run: prefill wall {kern_walls['prefill'] * 1e3:.1f} ms, decode step "
        f"wall {kern_walls['decode'] * 1e3:.2f} ms, peak memory {peak:.1f} GB; launches "
        f"{launches}")
    del lk, lp
    torch.cuda.empty_cache()
    return launches


def phase_recurrent_main(smi) -> dict:
    """5n ([recurrent-main]): recurrentgemma-2b at its published widths (26
    layers, d 2560, 10 heads over 1 kv head at hd 256, window 2048, vocab
    256,000; bf16, seeded random weights): the single batch (4 x 64 + 64,
    window 96; swa_decode) through its decode graph; a 4 x 4096 prefill (the
    rings of 2048 wrap; flash_prefill) and 32 decode steps (paged_decode_ring)
    through the kernels against the plain versions (bf16: logits within 0.1
    x scale, the prefill's window dropped outside; float32 over every
    layer, a float32 copy beside the bf16 weights: within 1e-3 x scale, the
    prefill's mask shifted by one outside).
    Then xlstm-125m at its published widths (12 layers, d 768, vocab
    50,304): the single batch (4 x 64 + 64) and a 4 x 512 prefill with 8
    decode steps, finite logits (no kernel on its path). Returns the kernel
    runs' launches."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    for spec in (RG_MAIN, XLSTM_MAIN):
        t0 = time.perf_counter()
        cfg = get_config(spec["arch"])
        model = build_model(cfg)
        torch.cuda.reset_peak_memory_stats()
        params = model.init(torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
        log(f"[recurrent-main] {cfg.name}: {cfg.arch_type}, {cfg.n_layers} layers, d "
            f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.resolved_head_dim}, "
            f"vocab {cfg.vocab_size}, {cfg.dtype}: {_numel(params) / 1e9:.3f} B parameters, "
            f"{_nbytes(params) / 1e9:.2f} GB")
        add(_recurrent_serve(smi, model, params, "recurrent-main", *spec["serve"]))
        gen = torch.Generator().manual_seed(5)
        prompts = torch.randint(0, cfg.vocab_size, (spec["batch"], spec["prompt"]),
                                generator=gen).to(DEVICE)
        feeds = torch.randint(0, cfg.vocab_size, (spec["batch"], spec["steps"]),
                              generator=gen).to(DEVICE)
        hybrid = cfg.arch_type == "hybrid"
        # bf16 gates the dropped window; the one-key shift moves the bf16
        # logits by as much as the kernel's own rounding (0.022 against 0.020
        # x scale on an H100): float32 gates it
        launches = _recurrent_parity(
            smi, model, params, "recurrent-main", prompts, feeds,
            [("window dropped", dict(flash_prefill=_prefill_no_window))] if hybrid else [])
        add(launches)
        if hybrid:
            check(launches.get("flash_prefill", 0) > 0 and launches.get("paged_decode_ring", 0) > 0,
                  f"{cfg.name}: a kernel of its path never launched: {launches}")
            cfg32 = dataclasses.replace(cfg, dtype="float32")
            params32 = _cast(params, torch.float32)
            log(f"[recurrent-main] {cfg.name}: float32 parity over all {cfg.n_layers} layers "
                f"({4 * _numel(params) / 1e9:.1f} GB copy beside the bf16 weights)")
            add(_recurrent_parity(smi, build_model(cfg32), params32, "recurrent-main", prompts,
                                  feeds, [("mask shifted by one",
                                           dict(flash_prefill=_prefill_shift))]))
            del params32
        log(f"[recurrent-main] {cfg.name}: peak device memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB; wall "
            f"{time.perf_counter() - t0:.1f} s")
        del params, model
        gc.collect()
        torch.cuda.empty_cache()
    return total


# ----------------------------------------------------------------- phase 7g
# The recurrent families' federated training at TRAIN's settings: (arch,
# layers trained; None = every layer). recurrentgemma-2b trains 3 of its 26
# layers (one whole period, 2 RG-LRU and 1 local attention): 1.544 B
# parameters, 1.311 B of them the untied embedding and unembedding of its
# 256,000-token vocabulary, near stablelm-1.6b's 1.644 B, which trains two
# clouds on the card in ~62 GB. Its 12 layers (2.244 B parameters;
# ``ModelConfig.param_count`` leaves the unembedding out and says 1.58 B)
# ran out of the card's 80 GB in the first local step (NVIDIA H100 80GB
# HBM3, 700.00 W): two clouds' weights, Adam moments and error feedback
# and a gradient take ~36 B a parameter.
RECURRENT_TRAIN = (("recurrentgemma-2b", 3), ("xlstm-125m", None))



@contextlib.contextmanager
def _train_layers(depth):
    """``run_training``'s config cut to its first ``depth`` layers."""
    from repro_torch.launch import train

    saved = train.get_config
    if depth is not None:
        train.get_config = lambda arch: dataclasses.replace(saved(arch), n_layers=depth)
    try:
        yield
    finally:
        train.get_config = saved


def phase_training_recurrent(smi) -> dict:
    """7g ([train-recurrent]): FedAvg of both recurrent families at
    ``TRAIN``'s settings (2 clouds, topk+int8, DP clip and noise, 4 steps of
    8 x 256 per cloud): xlstm-125m at its published widths (its sLSTM scan
    through ``SlstmScan``), recurrentgemma-2b at its published widths over
    3 of its 26 layers (``RECURRENT_TRAIN``); finite losses, every channel
    kernel launched; local-step walls and peak memory; a sync round from a
    copy of the trained state through the kernels and through the plain
    versions (``_sync_parity``: the new global params equal within
    ``SYNC_DIFF_FRAC``). Returns the channel kernels' launches."""
    import torch

    from repro_torch.configs import get_config

    total = {k: 0 for k in CHANNEL}
    for arch, depth in RECURRENT_TRAIN:
        label = f"train-{arch}"
        with _train_layers(depth):
            res, walls, launches, peak, t_all = _timed_run(label, arch=arch)
        line, _ = _run_summary(res, walls, launches, peak, t_all)
        cfg = res["trainer"].model.cfg
        log(f"[train-recurrent] {arch} ({smi}), {cfg.n_layers} of {get_config(arch).n_layers} "
            f"layers (param_count {cfg.param_count() / 1e9:.3f} B): {line}")
        for k in CHANNEL:
            total[k] += launches[k]
        arrived = torch.ones(TRAIN["n_clouds"], dtype=torch.bool, device=DEVICE)
        alphas = torch.full((TRAIN["n_clouds"],), 0.5, device=DEVICE)
        _sync_parity(label, res["trainer"], res["state"], arrived, alphas)
        del res
        gc.collect()
        torch.cuda.empty_cache()
    return total


def phase_training_recurrent_isolated() -> dict:
    """7g (``phase_training_recurrent``) in a process of its own, started
    before any other phase touches the card: after the whole script's
    serving and training phases, the caching allocator held 83.5 GB
    reserved around no live block that ``empty_cache`` would not release,
    and recurrentgemma-2b's 2.4 GB embedding was refused (NVIDIA H100 80GB
    HBM3, 700.00 W). The child builds nothing (the libraries are built) and
    prints its log as it runs; its launches and failed numeric checks come
    back through ``build/phase_7g.json``; this process waits for it."""
    out = ROOT / "build" / "phase_7g.json"
    out.unlink(missing_ok=True)
    code = ("import json, chip_smoke as c; smi = c.phase_device(); "
            "r = c.phase_training_recurrent(smi); "
            f"open({str(out)!r}, 'w').write(json.dumps({{'launches': r, 'failed': c.FAILED}}))")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=1200)
    res = json.loads(out.read_text())
    FAILED.extend(res["failed"])
    return res["launches"]


# ------------------------------------------------------- phases 3w-3x, 5w
# whisper-medium's attention shapes: the encoder's self-attention (S = T =
# 1500 frames) and the decoder's cross-attention over them (a 64-token
# prompt, one query), non-causal through flash_prefill; the decode step's
# cross-attention through the ring decodes over a full ring of 1500 keys.
WHISPER_KERNELS = dict(b=4, t=1500, hkv=16, g=1, hd=64, prompt=64)


def _noncausal_as_causal(q, k, v, *, causal=True, window=0, scale=None):
    """Planted fault: the causal mask applied where every key counts."""
    from repro_torch.kernels import ref

    return ref.flash_prefill_ref(q, k, v, window=window, scale=scale)


def _noncausal_drop_last(q, k, v, *, causal=True, window=0, scale=None):
    """Planted fault: non-causal attention over T - 1 keys (the last key of
    the last, partial tile dropped); causal calls stay sound."""
    from repro_torch.kernels import ref

    if causal:
        return ref.flash_prefill_ref(q, k, v, window=window, scale=scale)
    return ref.flash_prefill_ref(q, k[:, :-1], v[:, :-1], causal=False, scale=scale)


def _prefill_no_causal(q, k, v, *, causal=True, window=0, scale=None):
    """Planted fault: the prefill's causal mask dropped (every query sees
    every key)."""
    from repro_torch.kernels import ref

    return ref.flash_prefill_ref(q, k, v, causal=False, scale=scale)


NONCAUSAL_FAULTS = (("causal mask applied", _noncausal_as_causal),
                    ("last key dropped (T - 1 keys)", _noncausal_drop_last))


def phase_kernels_whisper(smi) -> list[dict]:
    """3w-3x, 5w ([whisper-kernels]): ``flash_prefill(causal=False)`` at
    whisper-medium's shapes (B 4, Hkv 16, G 1, hd 64, T 1500: S = 1500, the
    encoder, 3w; S 64, the prefill's cross-attention, 3x; S 1), in bf16 (the
    tensor-core body) and float32 (SIMT), each within ``RTOL`` of its plain
    version (bf16: one-ulp flips left out, ``_flip_gated``), the planted
    faults (the causal mask applied; the last key dropped) outside;
    ``swa_decode`` and ``paged_decode_ring`` over a ring of C 1500 at pos
    1499 (every slot live: the decode step's cross-attention, 5w) within
    ``RTOL`` of their plain versions and BITWISE equal, the newest key or
    the whole page dropped outside. bf16 is timed: device ms, wrapper
    wall, the plain version's ms, SDPA's (``is_causal=False``), the bound.
    Returns the timed rows."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    c = WHISPER_KERNELS
    b, t, hkv, g, hd = c["b"], c["t"], c["hkv"], c["g"], c["hd"]
    h = hkv * g
    gen = torch.Generator().manual_seed(29)
    timed = []
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        tol = RTOL[dname]
        elem = dt.itemsize
        tag = f"Hkv{hkv} G{g} hd{hd} {dname}"

        def rnd(*shape):
            return torch.randn(*shape, generator=gen).to(DEVICE, dt)

        k4, v4 = rnd(b, t, hkv, hd), rnd(b, t, hkv, hd)
        kt, vt = k4.transpose(1, 2), v4.transpose(1, 2)
        rows = []
        for row, s in (("3w", t), ("3x", c["prompt"]), ("3x S1", 1)):
            q5 = rnd(b, s, hkv, g, hd)
            out = ops.flash_prefill_attention(q5, k4, v4, causal=False)
            torch.cuda.synchronize()
            exact = ref.flash_prefill_ref(q5.float(), k4.float(), v4.float(), causal=False)
            e_fp, raw, e_abs = _flip_gated(out, exact, dt)
            expect(e_fp <= tol, f"flash_prefill non-causal {tag} S{s} T{t}: err/RMS {e_fp} > "
                                f"{tol}")
            rms = exact.pow(2).mean().sqrt().item()
            msg = (f"[whisper-kernels] flash_prefill non-causal {tag} B{b} S{s} T{t} (row {row})"
                   f": err/RMS {e_fp:.3e}"
                   + (f" beyond one-ulp flips ({raw:.3e} with them)" if dt == torch.bfloat16
                      else "") + f" (tol {tol:g})")
            for fname, fn in NONCAUSAL_FAULTS:
                fe = (out.float() - fn(q5.float(), k4.float(), v4.float(), causal=False)
                      ).abs().max().item() / rms
                expect(fe > tol, f"flash_prefill non-causal {tag} S{s}: planted fault '{fname}' "
                                 "within tolerance")
                msg += f"; planted fault '{fname}' err/RMS {fe:.3e}"
            log(msg)
            if dt == torch.bfloat16 and s > 1:
                qt = q5.reshape(b, s, h, hd).transpose(1, 2)
                rows.append(dict(
                    name="flash_prefill", max_abs_err=e_abs, err=e_fp,
                    kern=lambda q5=q5: ops.flash_prefill_attention(q5, k4, v4, causal=False),
                    plain=lambda q5=q5: ref.flash_prefill_ref(q5, k4, v4, causal=False),
                    lib=lambda qt=qt: F.scaled_dot_product_attention(qt, kt, vt,
                                                                      is_causal=False),
                    nbytes=(2 * b * s * h * hd + 2 * b * t * hkv * hd) * elem,
                    flops=4 * b * h * hd * s * t, lib_what="SDPA, is_causal=False",
                    shape=f"row {row}: {tag} B{b} S{s} T{t} non-causal"))
            del out, exact
        # --- the decode step's cross-attention: a full ring of T keys
        q = rnd(b, hkv, g, hd)
        pos = torch.full((b,), t - 1, dtype=torch.int32, device=DEVICE)
        ring = ops.swa_decode_attention(q, k4, v4, t - 1, 0, paged=True)
        swa = ops.swa_decode_attention(q, k4, v4, t - 1, 0, paged=False)
        same = torch.equal(ring, swa)
        expect(same, f"{tag}: paged_decode_ring and swa_decode differ at C {t}")
        exact = _ring_plain(q.float(), k4.float(), v4.float(), pos, 0).float()
        rms = exact.pow(2).mean().sqrt().item()
        msg = (f"[whisper-kernels] cross decode {tag} B{b} C{t} pos {t - 1} (row 5w): "
               f"paged_decode_ring == swa_decode bitwise {same}")
        for name, o in (("paged_decode_ring", ring), ("swa_decode", swa)):
            e = (o.float() - exact).abs().max().item()
            expect(e <= tol * rms, f"{name} {tag} C{t}: err/RMS {e / rms} > {tol}")
            msg += f"; {name} err/RMS {e / rms:.3e}"
        for fname, kind in RING_FAULTS:
            if kind == "nowrap":   # pos = C - 1: nothing has wrapped
                continue
            fe = (ring.float() - _ring_plain(q.float(), k4.float(), v4.float(), pos, 0,
                                             fault=kind).float()).abs().max().item() / rms
            expect(fe > tol, f"paged_decode_ring {tag} C{t}: planted fault '{fname}' within "
                             "tolerance")
            msg += f"; planted fault '{fname}' err/RMS {fe:.3e}"
        log(msg + f" (tol {tol:g}); {_split_plan(t, q.shape, [t] * b)}")
        if dt == torch.bfloat16:
            qd = q.reshape(b, h, 1, hd)
            for name, paged in (("swa_decode", False), ("paged_decode_ring", True)):
                e = (ring if paged else swa).float().sub(exact).abs().max().item()
                rows.append(dict(
                    name=name, max_abs_err=e, err=e / rms,
                    kern=lambda paged=paged: ops.swa_decode_attention(q, k4, v4, t - 1, 0,
                                                                       paged=paged),
                    plain=lambda paged=paged: (ref.ring_paged_decode_ref if paged else
                                               ref.swa_decode_ref)(q, k4, v4, pos, 0),
                    lib=lambda: F.scaled_dot_product_attention(qd, kt, vt, is_causal=False),
                    nbytes=2 * b * h * hd * elem + 2 * b * t * hkv * hd * elem + 4 * b,
                    flops=4 * b * t * h * hd, lib_what="SDPA over the T keys",
                    shape=f"row 5w: {tag} B{b} C{t} pos {t - 1}"))
            timed += [_hd256_timed(smi, r, "whisper-kernels") for r in rows]
        del q, k4, v4, kt, vt, ring, swa, exact, rows
        torch.cuda.empty_cache()
    return timed


# ----------------------------------------------------------------- phase 4j
# The reference's float32 traces of pixtral and whisper (written by
# tests/test_torch_whisper.py).
GOLDEN_VLM_AUDIO = "golden_vlm_audio_smoke.json"


def _golden_inputs(cfg, b: int, seed: int) -> dict:
    """The golden file's patch or audio embeddings: N(0, 1) float32 from
    numpy's ``seed``, (b, vision_seq or encoder_seq, d_model)."""
    import torch

    n, key = ((cfg.encoder_seq, "audio_embeds") if cfg.arch_type == "audio" else
              (cfg.vision_seq, "patch_embeds"))
    x = np.random.default_rng(seed).standard_normal((b, n, cfg.d_model), dtype=np.float32)
    return {key: torch.from_numpy(x).to(DEVICE)}


def _prefill_then_decode(model, params, prompts, inputs: dict, gen: int) -> list:
    """``prefill`` (the image prefix or the encoder, then the prompt) into
    rings with room for ``gen`` more tokens, then ``gen`` greedy decode
    steps: the tokens."""
    import torch

    cfg = model.cfg
    prefix = cfg.vision_seq if cfg.arch_type == "vlm" else 0
    cache, logits = model.prefill(params, {"tokens": prompts, **inputs},
                                  cache_window=prefix + prompts.shape[1] + gen)
    out = []
    tok = logits[:, :cfg.vocab_size].argmax(-1, keepdim=True)
    for _ in range(gen):
        out.append(tok)
        cache, logits = model.decode(params, cache, tok)
        tok = logits[:, :cfg.vocab_size].argmax(-1, keepdim=True)
    return torch.cat(out, 1).tolist()


def phase_golden_vlm_audio() -> dict:
    """4j ([golden-vlm-audio]): the reference's float32 greedy traces of
    whisper-medium and pixtral-12b at their smoke configs on the card, on
    numpy-seeded weights, audio and patches: the single batch (whisper
    without and with a window of 6 that its prompts wrap; pixtral from its
    tokens alone, as the reference's ``serve_batch``) through
    ``generate_batch``'s decode graph, and ``prefill`` then decode (whisper's
    encoder and prompt; pixtral's 16-patch prefix and prompt): every token.
    Returns the launches."""
    import torch

    from repro_torch.bridge import numpy_params, params_from_numpy
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch.graphs import GraphCache
    from repro_torch.launch.serve import generate_batch
    from repro_torch.models.model import build_model

    g = json.loads((ROOT / "src/repro_torch/testdata" / GOLDEN_VLM_AUDIO).read_text())
    total = {k: 0 for k in ops.LAUNCHES}

    def smoke32(arch):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        return build_model(cfg), params_from_numpy(numpy_params(cfg, g["seed"]), cfg, DEVICE)

    def tally():
        torch.cuda.synchronize()
        launched = {k: v for k, v in ops.LAUNCHES.items() if v}
        for k, v in launched.items():
            total[k] += v
        return launched

    for case in g["serve"]:
        model, params = smoke32(case["arch"])
        prompts = torch.tensor(case["prompts"], device=DEVICE)
        audio = model.cfg.arch_type == "audio"
        inputs = _golden_inputs(model.cfg, len(prompts), g["inputs_seed"]) if audio else {}
        graphs = GraphCache(DEVICE)
        ops.reset_launches()
        gen, _, _ = generate_batch(model, params, prompts, case["gen"], window=case["window"],
                                   graphs=graphs, inputs=inputs)
        launched = tally()
        check(gen.tolist() == case["tokens"], f"golden single batch {case['arch']} window "
                                              f"{case['window']}: fp32 tokens differ from the "
                                              "reference's")
        need = ("flash_prefill", "swa_decode") if audio else ("swa_decode",)
        check(all(launched.get(k, 0) > 0 for k in need),
              f"golden single batch {case['arch']}: a kernel never launched: {launched}")
        log(f"[golden-vlm-audio] single batch {case['arch']} window {case['window']}: "
            f"{len(case['prompts'])} x {len(case['prompts'][0])} + {case['gen']}, fp32 greedy "
            f"tokens identical to the reference's; compiles {graphs.counts}; launches {launched}")
    for case in g["prefill"]:
        model, params = smoke32(case["arch"])
        prompts = torch.tensor(case["prompts"], device=DEVICE)
        ops.reset_launches()
        got = _prefill_then_decode(model, params, prompts,
                                   _golden_inputs(model.cfg, len(prompts), g["inputs_seed"]),
                                   case["gen"])
        launched = tally()
        check(got == case["tokens"], f"golden prefill {case['arch']}: fp32 tokens differ from "
                                     "the reference's")
        check(all(launched.get(k, 0) > 0 for k in ("flash_prefill", "paged_decode_ring")),
              f"golden prefill {case['arch']}: a kernel never launched: {launched}")
        log(f"[golden-vlm-audio] prefill {case['arch']}: {len(case['prompts'])} x "
            f"{len(case['prompts'][0])} + {case['gen']}, fp32 greedy tokens identical to the "
            f"reference's; launches {launched}")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return total


# ----------------------------------------------------------------- phase 5o
# whisper-medium's single batch (B 4, 1500 frames, prompt 64, gen 64) and
# pixtral-12b's multimodal prefill (B 4, 256 patches + 64 tokens) with 32
# decode steps, at their published widths. pixtral's float32 parity runs
# over its first FP32_LAYERS of 40 layers, as phase 5m's 12 B configs.
WHISPER_MAIN = dict(arch="whisper-medium", batch=4, prompt=64, gen=64, steps=16)
PIXTRAL_MAIN = dict(arch="pixtral-12b", batch=4, prompt=64, steps=32)


def _seeded_inputs(cfg, b: int, seed: int) -> dict:
    """Patch or audio embeddings N(0, 1) from a seeded generator on the
    card, in the model dtype."""
    import torch

    n, key = ((cfg.encoder_seq, "audio_embeds") if cfg.arch_type == "audio" else
              (cfg.vision_seq, "patch_embeds"))
    x = torch.randn((b, n, cfg.d_model), device=DEVICE, dtype=torch.float32,
                    generator=torch.Generator(device=DEVICE).manual_seed(seed))
    return {key: x.to(getattr(torch, cfg.dtype))}


def _whisper_main(smi, model, params) -> dict:
    """whisper-medium's single batch through its decode graph: the encoder
    wall (its second call), tok/s, the decode step's device time, launches
    and peak memory; then the logit parity. Returns the launches."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.engine import synthetic_prompts
    from repro_torch.launch.graphs import GraphCache
    from repro_torch.launch.serve import generate_batch
    from repro_torch.models import whisper
    from repro_torch.models.model import build_model

    cfg, spec = model.cfg, WHISPER_MAIN
    b = spec["batch"]
    total = {}
    inputs = _seeded_inputs(cfg, b, 2)
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        whisper.encode(cfg, params, inputs["audio_embeds"], kernel=True)
        torch.cuda.synchronize()
        enc_wall = time.perf_counter() - t0
    prompts = torch.from_numpy(synthetic_prompts(cfg, b, spec["prompt"], 0)).to(DEVICE)
    graphs = GraphCache(DEVICE)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    gen, t_prefill, t_gen = generate_batch(model, params, prompts, spec["gen"], graphs=graphs,
                                           inputs=inputs)
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(gen.shape == (b, spec["gen"]) and bool(((gen >= 0) & (gen < cfg.vocab_size)).all()),
          f"{cfg.name} single batch: output {tuple(gen.shape)} out of range")
    check(graphs.counts == {"decode": 1}, f"{cfg.name} single batch: compiles {graphs.counts}")
    check(all(launches.get(k, 0) > 0 for k in ("flash_prefill", "swa_decode")),
          f"{cfg.name} single batch: a kernel never launched: {launches}")
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    cache = model.init_cache(params, {"tokens": prompts, **inputs}, 256)
    tok = prompts[:, :1]
    step_ms, step_wall = timed_ms(lambda: model.decode(params, cache, tok, paged=False), iters=5)
    per_step = dict(LAST_KERNELS)
    del cache
    log(f"[vlm-audio-main] {cfg.name} single batch ({smi}): encoder {b} x {cfg.encoder_seq} "
        f"frames {enc_wall * 1e3:.1f} ms wall; {b} x {spec['prompt']} teacher-forced in "
        f"{t_prefill:.3f} s (encoder included), {spec['gen']} tokens/row in {t_gen:.3f} s: "
        f"{b * spec['gen'] / t_gen:.1f} tok/s; eager decode step {step_ms:.3f} ms device, "
        f"{step_wall:.3f} ms wall, {sum(n for n, _ in per_step.values()):.0f} kernel launches; "
        f"launches {launches}; compiles {graphs.counts}; graph pool "
        f"{graphs.pool_bytes() / 1e9:.3f} GB; peak {peak:.2f} GB")
    gen_ = torch.Generator().manual_seed(5)
    feeds = torch.randint(0, cfg.vocab_size, (b, spec["steps"]), generator=gen_).to(DEVICE)
    for k, v in _recurrent_parity(smi, model, params, "vlm-audio-main", prompts, feeds,
                                  [("causal mask in the non-causal attention",
                                    dict(flash_prefill=_noncausal_as_causal))],
                                  inputs=inputs, cache_window=spec["prompt"] + spec["steps"]
                                  ).items():
        total[k] = total.get(k, 0) + v
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = _cast(params, torch.float32)
    inputs32 = _cast(inputs, torch.float32)
    log(f"[vlm-audio-main] {cfg.name}: float32 parity over every layer "
        f"({4 * _numel(params) / 1e9:.1f} GB copy beside the bf16 weights)")
    for k, v in _recurrent_parity(smi, build_model(cfg32), params32, "vlm-audio-main", prompts,
                                  feeds, [("last frame dropped in the encoder and "
                                           "cross-attention", dict(
                                               flash_prefill=_noncausal_drop_last))],
                                  inputs=inputs32, cache_window=spec["prompt"] + spec["steps"]
                                  ).items():
        total[k] = total.get(k, 0) + v
    del params32, inputs32
    return total


def _pixtral_main(smi, model, params) -> dict:
    """pixtral-12b's multimodal prefill and decode steps through the
    kernels against the plain versions, bf16 and float32 over its first
    ``FP32_LAYERS`` layers. Returns the launches."""
    import torch

    from repro_torch.models.model import build_model

    cfg, spec = model.cfg, PIXTRAL_MAIN
    b = spec["batch"]
    total = {}
    inputs = _seeded_inputs(cfg, b, 3)
    gen = torch.Generator().manual_seed(6)
    prompts = torch.randint(0, cfg.vocab_size, (b, spec["prompt"]), generator=gen).to(DEVICE)
    feeds = torch.randint(0, cfg.vocab_size, (b, spec["steps"]), generator=gen).to(DEVICE)
    window = cfg.vision_seq + spec["prompt"] + spec["steps"]
    for k, v in _recurrent_parity(smi, model, params, "vlm-audio-main", prompts, feeds,
                                  [("causal mask dropped", dict(flash_prefill=_prefill_no_causal))],
                                  inputs=inputs, cache_window=window).items():
        total[k] = total.get(k, 0) + v
    depth = FP32_LAYERS
    cfg32 = dataclasses.replace(cfg, dtype="float32", n_layers=depth)
    params32 = _cast(_first_layers(params, depth), torch.float32)
    log(f"[vlm-audio-main] {cfg.name}: float32 parity over {depth} of {cfg.n_layers} layers "
        f"(cut: a float32 copy of every layer, {4 * _numel(params) / 1e9:.1f} GB, beside the "
        f"{_nbytes(params) / 1e9:.1f} GB of bf16 weights passes {FP32_COPY_BYTES / 1e9:.0f} GB)")
    for k, v in _recurrent_parity(smi, build_model(cfg32), params32, "vlm-audio-main", prompts,
                                  feeds, [("mask shifted by one",
                                           dict(flash_prefill=_prefill_shift))],
                                  inputs=_cast(inputs, torch.float32), cache_window=window
                                  ).items():
        total[k] = total.get(k, 0) + v
    del params32
    return total


def phase_vlm_audio_main(smi) -> dict:
    """5o ([vlm-audio-main]): whisper-medium at its published widths (24 + 24
    layers, d 1024, 16 heads = 16 kv heads at hd 64, 1500 frames, vocab
    51,865, tied; bf16, seeded random weights and audio): the single batch
    4 x 64 + 64 through its decode graph (the encoder through
    ``flash_prefill``'s non-causal mode, the decode step's self- and
    cross-attention through ``swa_decode``), then a prefill of the 64-token
    prompt over the encoder with 16 decode steps (``paged_decode_ring``)
    through the kernels against the plain versions (bf16 logits within
    0.1 x scale, the causal mask in the encoder outside; float32 over every
    layer within 1e-3 x scale, the last frame dropped outside).
    pixtral-12b (40 layers, d 5120, 32/8 heads at hd 128, vocab 131,072,
    the projector; 12.27 B parameters): a prefill of 256 patches + 64
    tokens and 32 decode steps through the kernels against the plain
    versions (bf16 within 0.1 x scale, the causal mask dropped outside;
    float32 over its first 8 of 40 layers within 1e-3 x scale, the mask
    shifted by one outside). Returns the launches."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    total = {}
    for arch, run in (("whisper-medium", _whisper_main), ("pixtral-12b", _pixtral_main)):
        t0 = time.perf_counter()
        cfg = get_config(arch)
        model = build_model(cfg)
        torch.cuda.reset_peak_memory_stats()
        params = model.init(torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
        log(f"[vlm-audio-main] {cfg.name}: {cfg.arch_type}, {cfg.n_layers} layers"
            + (f" + {cfg.encoder_layers} encoder layers over {cfg.encoder_seq} frames"
               if cfg.encoder_layers else f", {cfg.vision_seq} patches") +
            f", d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, hd "
            f"{cfg.resolved_head_dim}, vocab {cfg.vocab_size}, {cfg.dtype}: "
            f"{_numel(params) / 1e9:.3f} B parameters, {_nbytes(params) / 1e9:.2f} GB")
        for k, v in run(smi, model, params).items():
            total[k] = total.get(k, 0) + v
        log(f"[vlm-audio-main] {cfg.name}: peak device memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB; wall "
            f"{time.perf_counter() - t0:.1f} s")
        del params, model
        gc.collect()
        torch.cuda.empty_cache()
    return total


# The training check's configurations: (arch, layers; None = every layer).
# pixtral-12b trains 4 of its 40 layers: at 40, its bf16 weights, gradients
# and the fp32 AdamW moments take ~12 bytes a parameter, 147 GB.
VLM_AUDIO_TRAIN = (("whisper-medium", None), ("pixtral-12b", 4))


def phase_train_vlm_audio(smi):
    """[train-vlm-audio]: one ``loss``, backward and AdamW step (lr 1e-3, as
    the reference's ``test_train_step_no_nans``), taken twice on the same
    batch (2 x 64 tokens with their audio or patch embeddings), for
    whisper-medium whole and pixtral-12b over 4 of its 40 layers: finite
    losses and parameters, and the second loss below the first; the step's
    wall and peak memory. (The federated trainer refuses both families:
    its corpus carries tokens only.)"""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import adamw_init, adamw_update
    from repro_torch.utils.grad import microbatched_value_and_grad
    from repro_torch.utils.tree import tree_leaves

    tcfg = TrainConfig(lr=1e-3, steps=10, warmup_steps=1)
    for arch, depth in VLM_AUDIO_TRAIN:
        cfg = get_config(arch)
        if depth is not None:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        model = build_model(cfg)
        torch.cuda.reset_peak_memory_stats()
        params = model.init(torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
        opt = adamw_init(params)
        toks = torch.randint(0, cfg.vocab_size, (2, 65),
                             generator=torch.Generator().manual_seed(7)).to(DEVICE)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], **_seeded_inputs(cfg, 2, 8)}
        losses, walls = [], []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (loss, _), grads = microbatched_value_and_grad(model.loss, params, batch)
            adamw_update(tcfg, grads, opt, params)
            del grads
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            losses.append(loss.item())
        finite = all(bool(torch.isfinite(x).all()) for x in tree_leaves(params))
        check(all(np.isfinite(losses)) and finite,
              f"train {arch}: non-finite loss or parameters: {losses}")
        check(losses[1] < losses[0], f"train {arch}: the loss did not drop on the same batch: "
                                     f"{losses}")
        log(f"[train-vlm-audio] {arch} ({smi}), {cfg.n_layers} of {get_config(arch).n_layers} "
            f"layers ({_numel(params) / 1e9:.3f} B parameters), batch 2 x 64: losses "
            f"{losses[0]:.4f} -> {losses[1]:.4f}, step walls {walls[0]:.3f} / {walls[1]:.3f} s, "
            f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        del params, opt, batch
        gc.collect()
        torch.cuda.empty_cache()


# ----------------------------------------------------------------- phase 3p
# The per-request path's kernel shapes (stablelm-1.6b: Hkv 32, G 1, hd 64,
# bf16): flash_prefill at B 1 over one prompt (a phase-5 cold prompt of 384
# tokens, causal; a ring prompt of 6144 tokens past its window of 4096,
# ``prefill_slot``'s call), suffix_prefill at width 1 (an exact 45-token
# suffix behind a 256-token prefix of 16 pages, W 16 as the engine buckets
# it). The 6144-token plain version runs 8 kv heads at a time.
PER_REQUEST_KERNELS = dict(hkv=32, hd=64, prompts=((384, 0), (6144, 4096)), suffix=45,
                           start=256, page=16, t_w=52, num_pages=60, heads=8)


def phase_kernels_per_request(smi) -> list[dict]:
    """3p, 2p ([per-request]): ``flash_prefill`` at B 1 and ``suffix_prefill``
    at width 1, bf16: each within ``RTOL`` of its plain version (one-ulp
    flips of the outputs left out, as in 3g), the shifted-mask fault
    outside; device and wrapper ms, the plain version's, SDPA's over the
    same keys, the bound. Returns the rows for the log."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    c = PER_REQUEST_KERNELS
    hkv, hd, tol = c["hkv"], c["hd"], RTOL["bfloat16"]
    gen = torch.Generator().manual_seed(31)
    rows = []

    def bound(nbytes, flops):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    for s, w in c["prompts"]:
        q5 = torch.randn(1, s, hkv, 1, hd, generator=gen).to(DEVICE, torch.bfloat16)
        k4 = torch.randn(1, s, hkv, hd, generator=gen).to(DEVICE, torch.bfloat16)
        v4 = torch.randn(1, s, hkv, hd, generator=gen).to(DEVICE, torch.bfloat16)
        out = ops.flash_prefill_attention(q5, k4, v4, window=w)
        gated = raw = err = fe = 0.0
        for h in range(0, hkv, c["heads"]):
            sl = (slice(None), slice(None), slice(h, h + c["heads"]))
            exact = ref.flash_prefill_ref(q5[sl].float(), k4[sl].float(), v4[sl].float(),
                                          window=w)
            g, r, e = _flip_gated(out[sl], exact, torch.bfloat16)
            gated, raw, err = max(gated, g), max(raw, r), max(err, e)
            if h == 0:
                rms = exact.pow(2).mean().sqrt().item()
                fault = _prefill_shift(q5[sl], k4[sl], v4[sl], window=w)
                fe = (out[sl].float() - fault.float()).abs().max().item() / rms
            del exact
        what = f"flash_prefill bfloat16 B1 S{s} Hkv{hkv} G1 hd{hd} window{w}"
        expect(gated <= tol, f"{what}: err/RMS beyond one-ulp flips {gated} > {tol}")
        expect(fe > tol, f"{what}: planted fault 'mask shifted by one' within tolerance")
        qt, kt, vt = (x.reshape(1, s, hkv, hd).transpose(1, 2) for x in (q5, k4, v4))
        # SDPA takes its flash backend where the mask is plain causal (as row
        # 3 times it); a window needs the explicit mask
        if w:
            pos = torch.arange(s, device=DEVICE)
            wmask = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < w)
            sdpa_kw, lib_what = dict(attn_mask=wmask), "SDPA, the windowed mask"
        else:
            sdpa_kw, lib_what = dict(is_causal=True), "SDPA, is_causal=True"
        ms, wall = timed_ms(lambda: ops.flash_prefill_attention(q5, k4, v4, window=w))
        plain_ms = timed_ms(lambda: ref.flash_prefill_ref(q5, k4, v4, window=w), iters=3)[0]
        lib = timed_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw))[0]
        pairs = sum(min(i + 1, w) if w else i + 1 for i in range(s))
        b_ms, b_by = bound(4 * s * hkv * hd * 2, 4 * hkv * hd * pairs)
        rows.append(dict(name="flash_prefill", shape=f"B1 S{s} window{w}", ms=ms,
                         wrapper_ms=wall, plain_ms=plain_ms, library_ms=lib, bound_ms=b_ms,
                         bound_by=b_by, max_abs_err=err))
        log(f"[per-request] {what} ({smi}): err/RMS beyond one-ulp flips {gated:.3e} (tol "
            f"{tol:g}), with them {raw:.3e}; planted fault 'mask shifted by one' {fe:.3e}; "
            f"kernel device ms {ms:.4f} (wrapper wall {wall:.4f}) plain_ms {plain_ms:.4f} "
            f"library_ms {lib:.4f} ({lib_what}) bound_ms {b_ms:.4f} ({b_by}: "
            f"{pairs} live pairs per head)")
        del q5, k4, v4, out, qt, kt, vt, sdpa_kw
        torch.cuda.empty_cache()

    s, start, page, t_w = c["suffix"], c["start"], c["page"], c["t_w"]
    w_pfx = -(-start // page)
    kp = torch.randn(c["num_pages"], page, hkv, hd, generator=gen).to(DEVICE, torch.bfloat16)
    vp = torch.randn(c["num_pages"], page, hkv, hd, generator=gen).to(DEVICE, torch.bfloat16)
    table = _table(gen, [-(-(start + s) // page)], t_w, c["num_pages"]).to(DEVICE)
    q5 = torch.randn(1, s, hkv, 1, hd, generator=gen).to(DEVICE, torch.bfloat16)
    ks = torch.randn(1, s, hkv, hd, generator=gen).to(DEVICE, torch.bfloat16)
    vs = torch.randn(1, s, hkv, hd, generator=gen).to(DEVICE, torch.bfloat16)
    starts = torch.tensor([start], dtype=torch.int32, device=DEVICE)
    args = (q5, ks, vs, kp, vp, table, starts)
    out = ops.suffix_prefill_attention(*args, prefix_width=w_pfx)
    exact = ref.suffix_prefill_ref(*(x.float() if x.is_floating_point() else x for x in args),
                                   prefix_width=w_pfx)
    gated, raw, err = _flip_gated(out, exact, torch.bfloat16)
    rms = exact.pow(2).mean().sqrt().item()
    faults = {"last prefix key dropped": _suffix_shift(*args, prefix_width=w_pfx),
              "last prefix page dropped": _suffix_drop_page(*args, prefix_width=w_pfx)}
    fes = {k: (out.float() - f.float()).abs().max().item() / rms for k, f in faults.items()}
    what = f"suffix_prefill bfloat16 n1 S{s} start{start} W{w_pfx} Hkv{hkv} G1 hd{hd}"
    expect(gated <= tol, f"{what}: err/RMS beyond one-ulp flips {gated} > {tol}")
    for k, fe in fes.items():
        expect(fe > tol, f"{what}: planted fault '{k}' within tolerance")
    kc = torch.cat([ref.gather_pages_ref(kp, table[:, :w_pfx])[:, :start], ks], 1).transpose(1, 2)
    vc = torch.cat([ref.gather_pages_ref(vp, table[:, :w_pfx])[:, :start], vs], 1).transpose(1, 2)
    smask = (torch.arange(start + s, device=DEVICE)[None, :]
             <= start + torch.arange(s, device=DEVICE)[:, None])
    qt = q5.reshape(1, s, hkv, hd).transpose(1, 2)
    ms, wall = timed_ms(lambda: ops.suffix_prefill_attention(*args, prefix_width=w_pfx))
    plain_ms = timed_ms(lambda: ref.suffix_prefill_ref(*args, prefix_width=w_pfx))[0]
    lib = timed_ms(lambda: F.scaled_dot_product_attention(qt, kc, vc, attn_mask=smask))[0]
    b_ms, b_by = bound((4 * s + 2 * start) * hkv * hd * 2 + 4 * (1 + w_pfx),
                       4 * hkv * hd * (s * start + s * (s + 1) // 2))
    rows.append(dict(name="suffix_prefill", shape=f"n1 S{s} start{start}", ms=ms,
                     wrapper_ms=wall, plain_ms=plain_ms, library_ms=lib, bound_ms=b_ms,
                     bound_by=b_by, max_abs_err=err))
    log(f"[per-request] {what} ({smi}): err/RMS beyond one-ulp flips {gated:.3e} (tol {tol:g}), "
        f"with them {raw:.3e}; planted faults " + ", ".join(f"'{k}' {v:.3e}" for k, v in
                                                           fes.items())
        + f"; kernel device ms {ms:.4f} (wrapper wall {wall:.4f}) plain_ms {plain_ms:.4f} "
        f"library_ms {lib:.4f} (SDPA over the same keys) bound_ms {b_ms:.4f} ({b_by})")
    del kp, vp, q5, ks, vs, out, exact, kc, vc
    torch.cuda.empty_cache()
    return rows


# ----------------------------------------------------------------- phase 4k
GOLDEN_PER_REQUEST = "golden_stablelm_smoke_per_request.json"
# per run of the golden file: the kernels its path must launch
GOLDEN_PER_REQUEST_KERNELS = (("flash_prefill", "paged_decode_ring"),
                              ("flash_prefill", "suffix_prefill", "paged_decode"),
                              ("flash_prefill", "suffix_prefill_int8", "paged_decode_int8",
                               "kv_write_int8"))


def phase_golden_per_request():
    """4k ([golden-per-request]): the reference engine's float32 traces with
    ``batch_prefill=False`` (rings with a window the prompts wrap:
    ``prefill_slot``; the pool with prefix hits: width-1 cold and suffix
    dispatches; int8 pages in a pool that preempts), replayed through CUDA
    graphs: tokens, dispatch counters and ``compiles`` identical, each
    path's kernels launched."""
    import torch

    from repro_torch.bridge import numpy_params, params_from_numpy
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch.engine import Request, ServeEngine
    from repro_torch.models.model import build_model

    g = json.loads((ROOT / "src/repro_torch/testdata" / GOLDEN_PER_REQUEST).read_text())
    cfg = dataclasses.replace(get_smoke_config("stablelm-1.6b"), dtype="float32")
    model = build_model(cfg)
    params = params_from_numpy(numpy_params(cfg, g["seed"]), cfg, DEVICE)
    for run, kernels in zip(g["runs"], GOLDEN_PER_REQUEST_KERNELS):
        eng = ServeEngine(model, params, device=DEVICE, **run["engine"])
        before = dict(ops.LAUNCHES)
        outs = eng.run([Request(uid=u, prompt=np.asarray(p, np.int32),
                                max_new_tokens=g["max_new_tokens"])
                        for u, p in enumerate(run["prompts"])])
        torch.cuda.synchronize()
        launched = {k: ops.LAUNCHES[k] - before[k] for k in kernels}
        got = [o.tokens for o in outs]
        counters = {k: getattr(eng, k) for k in run["counters"]}
        compiles = {k: eng.compiles[k] for k in run["compiles"]}
        check(got == run["tokens"], f"golden per-request run {run['name']}: tokens differ "
                                    f"from the reference:\n{got}\n{run['tokens']}")
        check(counters == run["counters"], f"golden per-request run {run['name']}: counters "
                                           f"{counters} vs {run['counters']}")
        check(compiles == run["compiles"], f"golden per-request run {run['name']}: compiles "
                                           f"{compiles} vs {run['compiles']}")
        check(all(v > 0 for v in launched.values()),
              f"golden per-request run {run['name']} missed a kernel: {launched}")
        log(f"[golden-per-request] {run['name']}: {len(got)} requests, fp32 greedy tokens, "
            f"counters {counters} and compiles {compiles} identical to the reference "
            f"engine's; kernel launches {launched}")
        del eng


# ------------------------------------------------------------- dry run
def start_dryrun(out_dir: pathlib.Path):
    """The dry run's whole table (10 architectures x 4 input shapes x 2
    production meshes, ``repro_torch.launch.dryrun``), started in a process
    of its own: it needs no device, and runs beside the kernels' build,
    which times nothing. Returns (process, records file, start time)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / "dryrun.jsonl"
    out.unlink(missing_ok=True)
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "all", "--shape", "all",
         "--multi-pod", "both", "--out", str(out)],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    def stop():  # a run that fails before reading it leaves no process behind
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    atexit.register(stop)
    return proc, out, time.perf_counter()


DRYRUN_TRAIN = dict(arch="stablelm-1.6b", seq_len=256, per_cloud_batch=8)


def phase_dryrun(smi, started):
    """The dry run ([dryrun]): the table's 80 records (no error, every
    compiler-only field null) and its wall; then stablelm-1.6b's single-pod
    training record on a one-device logical mesh (data 1 x model 1) at
    phase 7's per-cloud shape (8 x 256): its ``argument_bytes`` must equal
    exactly the bytes of the parameters, AdamW state and batch the port's
    trainer holds on the card (its step count, a host int, counted as the
    reference's int32 scalar), printed beside the caching allocator's
    growth while they were made."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticCorpus
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import LogicalMesh
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import adamw_init

    proc, out, t0 = started
    _, err = proc.communicate(timeout=600)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"the dry run failed: {err[-2000:]}")
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    check(len(recs) == 80 and not any("error" in r for r in recs),
          f"the dry run wrote {len(recs)} records: {[r for r in recs if 'error' in r]}")
    check(all(_counted(r) for r in recs),
          "a dry-run record leaves a counted field null or fills a compiler-only one: "
          f"{[(r['arch'], r['shape'], r['mesh']) for r in recs if not _counted(r)]}")
    big = max(recs, key=lambda r: r["memory"]["argument_bytes"])
    log(f"[dryrun] {len(recs)} records (10 architectures x 4 shapes x 2 meshes) in {wall:.1f} s "
        f"(beside the kernels' build; the process's own wall), every counted field filled; "
        f"largest arguments per device {big['memory']['argument_bytes'] / 2**30:.3f} GiB "
        f"({big['arch']} x {big['shape']} x {big['mesh']})")
    for r in recs:
        if r["arch"] == DRYRUN_TRAIN["arch"]:
            rf = r["roofline"]
            log(f"[dryrun] {r['arch']} x {r['shape']} x {r['mesh']}: "
                f"{r['hlo_flops_per_device']:.4e} FLOP and {r['hlo_bytes_per_device']:.4e} B a "
                f"device, temporaries {r['memory']['temp_bytes']:.4e} B; compute "
                f"{rf['compute_s'] * 1e3:.3f} ms, memory {rf['memory_s'] * 1e3:.3f} ms, "
                f"collective {rf['collective_s'] * 1e3:.3f} ms (ici {rf['ici_link_bytes']:.4e} "
                f"B, dcn {rf['dcn_link_bytes']:.4e} B) -> {r['dominant']}; useful "
                f"{r['useful_flops_ratio']:.3f}")

    c = DRYRUN_TRAIN
    cfg = get_config(c["arch"])
    shape = ShapeConfig("phase7", c["seq_len"], c["per_cloud_batch"], "training")
    _, mem = dryrun.memory_plan(cfg, shape, LogicalMesh(("data", "model"), (1, 1)))
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
    opt = adamw_init(params)
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, n_domains=4, noise=0.0)
    batch = corpus.sample(torch.Generator().manual_seed(0), torch.ones(4) / 4,
                          c["per_cloud_batch"], c["seq_len"])
    batch = {k: v.to(DEVICE) for k, v in batch.items() if k != "domain"}
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before
    held = _nbytes(params) + _nbytes(opt["m"]) + _nbytes(opt["v"]) + 4 + _nbytes(batch)
    check(held == mem["argument_bytes"],
          f"dry run: argument_bytes {mem['argument_bytes']} != the trainer's {held}")
    log(f"[dryrun] {cfg.name} training, one-device mesh, batch {c['per_cloud_batch']} x "
        f"{c['seq_len']} ({smi}): argument_bytes {mem['argument_bytes']} == the card's "
        f"parameters, AdamW m and v, step count and batch {held} B exactly; the caching "
        f"allocator grew {grown} B ({grown - held:+d} B: its block rounding); output_bytes "
        f"{mem['output_bytes']}")
    del model, params, opt, batch
    gc.collect()
    torch.cuda.empty_cache()
    phase_dryrun_counted(smi)


def _counted(r: dict) -> bool:
    """Whether a dry-run record fills every counted field and leaves null
    only what a compiler alone gives."""
    from repro_torch.launch import dryrun

    rf = r.get("roofline") or {}
    filled = (r["hlo_flops_per_device"], r["hlo_bytes_per_device"], r["useful_flops_ratio"],
              r["dominant"], r["memory"]["temp_bytes"],
              *(v for k, v in rf.items() if not k.startswith("xla_reported")))
    null = (r["compile_seconds"], r["memory"]["code_bytes"], rf.get("xla_reported_flops"),
            rf.get("xla_reported_bytes"))
    return (r["needs"] == list(dryrun.COMPILER_ONLY) and len(rf) == 9
            and all(v is not None for v in filled) and all(v is None for v in null))


# The steps counted on the card ((kind, sequence, batch): phase 7's per-cloud
# training batch, phase 5's prefill and decode widths) and, per step, the
# tolerance on |temp_bytes - the allocator's peak growth| / that growth,
# set before the first run that read them: the counter sees every tensor
# the step makes, the allocator also rounds each block up to 512 B and
# holds the kernels' internal workspaces and the reductions' scratch, a few
# MB at most, which a decode step's few-MB peak feels most.
DRYRUN_STEPS = (("training", 256, 8), ("prefill", 512, 8), ("decode", 512, 8))
TEMP_TOL = {"training": 0.10, "prefill": 0.10, "decode": 0.50}


def phase_dryrun_counted(smi):
    """The dry run's counted cost on the card ([dryrun]): stablelm-1.6b at
    its published widths on one device, ``utils/cost.count_step`` over the
    real training (8 x 256), prefill (8 x 512) and decode (8 rows over a
    512-slot ring) steps, with the kernels reporting as units. The card's
    FLOPs and bytes must EQUAL the meta count of the same step
    (``dryrun.step_cost`` on a one-device logical mesh, at the config's
    full depth), and both counts' ``temp_bytes`` (the card's, and the meta
    count's that the dry run's records carry) must lie within ``TEMP_TOL``
    of the caching allocator's peak growth over the arguments
    (``max_memory_allocated``, after a warm-up call). Printed beside them:
    the step's device time (the profiler's kernel rows) and wall, the
    roofline terms of the meta count (``compute_s``, ``memory_s``) and the
    share of each that results."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.data.pipeline import SyntheticCorpus
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import steps
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.utils import cost

    def no_grad(fn):
        def run(*args):
            with torch.no_grad():
                return fn(*args)
        return run

    cfg = get_config(DRYRUN_TRAIN["arch"])
    model = build_model(cfg)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
    one = meshlib.LogicalMesh((meshlib.DATA_AXIS, meshlib.MODEL_AXIS), (1, 1))
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, n_domains=4, noise=0.0)
    for kind, seq, batch in DRYRUN_STEPS:
        shape = ShapeConfig(kind, seq, batch, kind)
        t0 = time.perf_counter()
        meta = dryrun.step_cost(cfg, shape, one)
        t_meta = time.perf_counter() - t0
        data = corpus.sample(torch.Generator().manual_seed(0), torch.ones(4) / 4, batch, seq)
        if kind == "training":
            args = (params, adamw_init(params),
                    {k: data[k].to(DEVICE) for k in ("tokens", "labels")})
            fn = steps.make_train_step(model, TrainConfig(seq_len=seq, global_batch=batch))
        elif kind == "prefill":
            args = (params, {"tokens": data["tokens"].to(DEVICE)})
            fn = no_grad(steps.make_prefill_step(model, shape))
        else:
            tokens = data["tokens"][:, :1].to(DEVICE)
            args = (params, model.init_cache(params, {"tokens": tokens}, seq), tokens)
            fn = no_grad(steps.make_decode_step(model, 0))
        fn(*args)   # first-use allocations (cuBLAS workspaces) before the count
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        card = cost.count_step(fn, *args)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        grown = torch.cuda.max_memory_allocated() - base
        check(card.flops == meta.flops,
              f"dryrun {kind}: the card's counted FLOPs {card.flops} != the meta count "
              f"{meta.flops}")
        check(card.hbm_bytes == meta.hbm_bytes,
              f"dryrun {kind}: the card's counted bytes {card.hbm_bytes} != the meta count "
              f"{meta.hbm_bytes}")
        off = abs(card.temp_bytes - grown) / grown
        check(off <= TEMP_TOL[kind],
              f"dryrun {kind}: temp_bytes {card.temp_bytes:.0f} vs the allocator's peak growth "
              f"{grown} ({off:.3f} > tolerance {TEMP_TOL[kind]})")
        meta_off = abs(meta.temp_bytes - grown) / grown
        check(meta_off <= TEMP_TOL[kind],
              f"dryrun {kind}: the meta count's temp_bytes {meta.temp_bytes:.0f} vs the "
              f"allocator's peak growth {grown} ({meta_off:.3f} > tolerance {TEMP_TOL[kind]})")
        dev_ms, wall_ms = timed_ms(lambda: fn(*args), iters=3)
        compute_ms = meta.flops / meshlib.PEAK_FLOPS * 1e3
        memory_ms = meta.hbm_bytes / meshlib.HBM_BW * 1e3
        log(f"[dryrun] {cfg.name} {kind} {batch} x {seq}, one device ({smi}): counted FLOPs "
            f"{card.flops:.0f} on the card == {meta.flops:.0f} on meta tensors "
            f"(counts {t_card:.1f} s and {t_meta:.1f} s); bytes {card.hbm_bytes:.0f} card == "
            f"{meta.hbm_bytes:.0f} meta; temp_bytes {card.temp_bytes:.0f} card, "
            f"{meta.temp_bytes:.0f} meta, vs the allocator's peak growth {grown} ({off:.4f} "
            f"and {meta_off:.4f} of it; tolerance {TEMP_TOL[kind]}); device "
            f"{dev_ms:.3f} ms (wall {wall_ms:.3f} ms) vs compute_s {compute_ms:.3f} ms and "
            f"memory_s {memory_ms:.3f} ms: {compute_ms / dev_ms:.4f} of the bf16 peak, "
            f"{memory_ms / dev_ms:.4f} of the HBM rate")
        del args, fn
        gc.collect()
        torch.cuda.empty_cache()
    del model, params
    gc.collect()
    torch.cuda.empty_cache()


def phase_dp_transmit(smi):
    """``ops.dp_transmit`` over stablelm-1.6b's whole parameter tree
    (1,644,267,520 bf16 parameters, clip 1.0) on the card ([dp-transmit]):
    at stddev 0 and at stddev 0.1 its tree equals, bitwise, that of its
    plain clip and noise (``plain_channel``) from the kernel's global norm
    on the same generator's draws; the kernel's Σx² lies within 1e-5 of the
    plain sum's over the tree; the device time of one call."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import dp_clip, ops, ref
    from repro_torch.models.model import build_model
    from repro_torch.utils.tree import tree_leaves

    cfg = get_config(DRYRUN_TRAIN["arch"])
    params = build_model(cfg).init(torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
    n = _numel(params)
    check(n == 1_644_267_520, f"dp_transmit: {n} parameters")
    clip = 1.0
    sq, sq_plain = ops.tree_sq_norm(params), sum(ref.sq_norm_ref(x) for x in tree_leaves(params))
    rel = abs(sq.item() - sq_plain.item()) / sq_plain.item()
    check(rel <= 1e-5, f"dp_transmit: the kernels' sum of squares off the plain one by {rel}")
    for std in (0.0, 0.1):
        got = ops.dp_transmit(params, torch.Generator(device=DEVICE).manual_seed(7), clip, std)
        with plain_channel(sq_norm=dp_clip.sq_norm):
            want = ops.dp_transmit(params, torch.Generator(device=DEVICE).manual_seed(7), clip,
                                   std)
        same = all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want)))
        check(same, f"dp_transmit stddev {std}: the kernels' tree differs from the plain "
                    "clip and noise's")
        del got, want
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    dev_ms, wall_ms = timed_ms(lambda: ops.dp_transmit(params, gen, clip, 0.1), iters=3)
    log(f"[dp-transmit] {cfg.name} tree, {n} bf16 parameters ({smi}): bitwise the plain clip "
        f"and noise at stddev 0 and 0.1; sum of squares {sq.item():.6e} (plain {rel:.2e} off); "
        f"device {dev_ms:.3f} ms, wall {wall_ms:.3f} ms a call (the N(0, 1) draws included)")
    del params
    gc.collect()
    torch.cuda.empty_cache()


# Each torch example at a size that keeps its process within ~60 s on the card.
EXAMPLES = (
    ("torch_quickstart.py", "--steps", "8"),
    ("torch_federated_lm.py", "--steps", "20", "--d-model", "128", "--layers", "2"),
    ("torch_serve_longcontext.py",),
    ("torch_continuous_serving.py", "--stagger", "0.05"),
)


def phase_examples(smi):
    """The four torch examples ([examples]), each in a process of its own on
    the card, all four at once: each must exit 0, and the continuous-serving
    example must report every request's tokens identical to the
    single-batch oracle's."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    procs = [(name, subprocess.Popen([sys.executable, str(ROOT / "examples" / name), *args],
                                     cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True))
             for name, *args in EXAMPLES]
    try:
        for name, proc in procs:
            out, err = proc.communicate(timeout=240)
            check(proc.returncode == 0,
                  f"example {name} exited {proc.returncode}: {err[-2000:]}")
            if name == "torch_continuous_serving.py":
                check("identical to the single-batch oracle's: True" in out,
                      "continuous serving: an engine's tokens differ from the oracle's")
            tail = [line for line in out.splitlines() if line.strip()][-1]
            log(f"[examples] {name}: exit 0 ({smi}); last line: {tail.strip()}")
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    log(f"[examples] four examples in {time.perf_counter() - t0:.1f} s")


# ----------------------------------------------------------------- phase 5p
def _first_token_parity(cfg, label, runs, tol):
    """Per-request first-token logits through the kernels against the plain
    versions, from copies of one cache: ``runs`` is (what, cache, call)
    with ``call(cache) -> logits``; a ring prompt's planted fault (the mask
    shifted by one) must land outside."""
    import torch

    for what, cache, call, faults in runs:
        snap = {k: v.clone() for k, v in cache.items()}
        lk = call(cache)[:, : cfg.vocab_size].float()
        check(bool(torch.isfinite(lk).all()), f"{label} {what}: non-finite logits")
        got = {}
        for fname, swap in [("plain", {}), *faults]:
            twin = {k: v.clone() for k, v in snap.items()}
            with plain_kernels(**swap):
                got[fname] = call(twin)[:, : cfg.vocab_size].float()
            del twin
        scale = max(got["plain"].abs().max().item(), 1.0)
        d = (lk - got["plain"]).abs().max().item()
        expect(d <= tol * scale, f"{label} {what}: logit diff {d} > {tol} x {scale}")
        msg = (f"[per-request-main] {cfg.dtype} {what}: kernel vs plain max |dlogit| {d:.3e} = "
               f"{d / scale:.3e} x logit scale {scale:.2f} (tol {tol:g} x scale)")
        for fname, _ in faults:
            fd = (lk - got[fname]).abs().max().item()
            expect(fd > tol * scale, f"{label} {what}: planted fault '{fname}' within tolerance")
            msg += f"; planted fault '{fname}' {fd / scale:.3e} x scale"
        log(msg)
        del snap, got


def phase_per_request_main(smi, model, params, batched: dict, ring_batched: dict) -> dict:
    """5p ([per-request-main]): stablelm-1.6b at its published widths (bf16,
    phase 5's seeded weights) with ``batch_prefill=False``: phase 5's paged
    trace (width-1 cold and suffix dispatches) and 5c's ring trace (4 x
    4096 rings; prompts up to 6144 tokens wrap inside ``prefill_slot``),
    each printed beside the batched engine's readings of this run (tok/s,
    TTFT p50, dispatches, compiles, token agreement; no gate on the bf16
    tokens); every request's budget, finite logits, one prefill dispatch per
    request. Gates: the per-request first-token logits (a 6144-token and a
    700-token ring prompt through ``prefill_slot``, a cold and a suffix
    prompt through width-1 ``prefill_slots``) within 0.1 x scale of the
    plain path in bf16, the shifted mask outside; and in float32 the
    per-request logits of four ring prompts (two wrap) within 1e-3 x
    scale of one batched cold round's over the same prompts. Returns the
    kernels' launches of the two traces."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.engine import ServeEngine
    from repro_torch.models.model import build_model

    cfg = model.cfg
    cold, hits = batched["cold"], batched["hits"]
    eng = ServeEngine(model, params, num_slots=8, max_seq=384 + 32, page_size=16,
                      prefix_cache=True, paged_cache=True, device=DEVICE, batch_prefill=False)
    eng.warm(sorted({len(r.prompt) for r in cold}), gen_tokens=2)
    finite = []
    _tap(eng, finite)
    ops.reset_launches()
    outs, wall = _run_trace(eng, batched)
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    first = dict(counters=dict(eng.pool_stats), compiles=eng.compiles)
    again, a_wall = _run_trace(eng, batched)
    eng.graphs.tap = None
    check(bool(torch.stack(finite).all()), "per-request paged trace: non-finite logits")
    check(len(outs) == 16 and all(len(o.tokens) == 32 for o in outs.values()),
          "per-request paged trace: a request missed its budget")
    ps = first["counters"]
    check(ps["cold_dispatches"] + ps["suffix_dispatches"] == eng.prefill_dispatches == 16
          and ps["suffix_dispatches"] > 0, f"per-request paged trace: dispatches {ps}")
    check(all(launches.get(k, 0) > 0 for k in SERVING),
          f"per-request paged trace: a kernel never launched: {launches}")
    toks = {u: o.tokens for u, o in outs.items()}
    same = sum(toks[u] == batched["tokens"][u] for u in toks) / len(toks)
    bc = batched["record"]["counters"]
    log(f"[per-request-main] {_trace_line('fp pages, per request', smi, outs, wall, eng)}; "
        f"{ps['cold_dispatches']} cold + {ps['suffix_dispatches']} suffix dispatches (batched: "
        f"{bc['cold_dispatches']} + {bc['suffix_dispatches']}); compiles {first['compiles']} "
        f"(batched: {batched['record']['compiles']}); the batched engine of phase 5 read "
        f"{batched['tok_s']:.1f} tok/s, TTFT p50 {batched['ttft'] * 1e3:.1f} ms; token "
        f"agreement with it {same:.3f} of requests (bf16; no gate); again, every key "
        f"captured: {_trace_line('fp pages, per request', smi, again, a_wall, eng)}; "
        f"launches {launches}")
    del eng
    torch.cuda.empty_cache()

    r_toks, r_launches, eng, rec = _ring_trace(model, params, smi, "ring, per request",
                                               batch_prefill=False)
    check(eng.prefill_dispatches == len(RING_PROMPTS)
          and eng.compiles["prefill"] == len(set(RING_PROMPTS))
          and r_launches.get("flash_prefill", 0) > 0
          and r_launches.get("paged_decode_ring", 0) > 0,
          f"per-request ring trace: dispatches {eng.prefill_dispatches}, compiles "
          f"{eng.compiles}, launches {r_launches}")
    same = sum(r_toks[u] == ring_batched["tokens"][u] for u in r_toks) / len(r_toks)
    rb = ring_batched["record"]
    log(f"[per-request-main] ring per request: {rec['tok_s']:.1f} tok/s, TTFT p50 "
        f"{rec['ttft'] * 1e3:.1f} ms, {rec['counters']['prefill_dispatches']} prefill "
        f"dispatches, compiles {rec['compiles']}; the batched ring trace of 5c read "
        f"{rb['tok_s']:.1f} tok/s, TTFT p50 {rb['ttft'] * 1e3:.1f} ms, "
        f"{rb['counters']['prefill_dispatches']} dispatches, compiles {rb['compiles']}; token "
        f"agreement {same:.3f} of requests (bf16; no gate)")
    for k, v in r_launches.items():
        launches[k] = launches.get(k, 0) + v
    del eng
    torch.cuda.empty_cache()

    # first-token logits through the kernels against the plain path (bf16)
    rng = np.random.default_rng(23)
    ring = model.init_slot_cache(RING_SLOTS, max(RING_PROMPTS) + RING_GEN, window=RING_WINDOW,
                                 device=DEVICE)
    pool = model.init_paged_cache(2, 2 * 26 * 8 + 1, 16, 52, device=DEVICE)
    r = _parity_rounds(cold, hits)
    pool["table"][0].copy_(torch.from_numpy(r["table"][0]))
    pool["table"][1].copy_(torch.from_numpy(r["table_h"][0]))
    c_len, s_len = int(r["lengths"][0]), int(r["slens"][0])
    runs = []
    # (the shifted mask moves the last position of a prompt of thousands by
    # less than the bf16 tolerance; the dropped window moves it by more)
    for n, slot, fault in ((6144, 0, ("window dropped", _prefill_no_window)),
                           (700, 1, ("mask shifted by one", _prefill_shift))):
        t = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n), dtype=np.int32)).to(DEVICE)
        runs.append((f"prefill_slot S{n} (ring C {RING_WINDOW})", ring,
                     lambda c, t=t, slot=slot: model.prefill_slot(params, c, t, slot,
                                                                  window=RING_WINDOW)[1],
                     [(fault[0], dict(flash_prefill=fault[1]))]))
    one = torch.ones(1, dtype=torch.int32, device=DEVICE)
    runs.append((f"width-1 cold prefill S{c_len}", pool,
                 lambda c: model.prefill_slots(params, c, r["tokens"][:1, :c_len], one * c_len,
                                               one * 0)[1],
                 [("mask shifted by one", dict(flash_prefill=_prefill_shift))]))
    runs.append((f"width-1 suffix prefill S{s_len} start 256", pool,
                 lambda c: model.prefill_slots(params, c, r["stoks"][:1, :s_len], one * s_len,
                                               one, starts=r["starts"][:1],
                                               prefix_pages=r["pw"])[1],
                 [("last prefix page dropped", dict(suffix_prefill=_suffix_drop_page))]))
    _first_token_parity(cfg, "5p", runs, LOGIT_RTOL[cfg.dtype])
    del ring, pool, runs
    torch.cuda.empty_cache()

    # float32: per request against one batched cold round over the same prompts
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    params32 = _cast(params, torch.float32)
    lens = (6144, 5000, 700, 96)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32) for n in lens]
    cap = max(lens) + RING_GEN
    a = model32.init_slot_cache(len(lens), cap, window=RING_WINDOW, device=DEVICE)
    toks = np.zeros((len(lens), max(lens)), np.int32)
    for i, p in enumerate(prompts):
        toks[i, : p.size] = p
    t = torch.from_numpy(toks).to(DEVICE)
    lb = model32.prefill_slots(params32, a, t, torch.tensor(lens, device=DEVICE),
                               torch.arange(len(lens), device=DEVICE), window=RING_WINDOW)[1]
    del a
    b = model32.init_slot_cache(len(lens), cap, window=RING_WINDOW, device=DEVICE)
    lp = torch.cat([model32.prefill_slot(params32, b, t[i:i + 1, :n], i, window=RING_WINDOW)[1]
                    for i, n in enumerate(lens)])
    lb, lp = lb[:, : cfg.vocab_size], lp[:, : cfg.vocab_size]
    tol = LOGIT_RTOL["float32"]
    scale = max(lb.abs().max().item(), 1.0)
    d = (lb - lp).abs().max().item()
    agree = (lb.argmax(-1) == lp.argmax(-1)).float().mean().item()
    expect(d <= tol * scale, f"5p float32: per-request vs batched logits {d} > {tol} x {scale}")
    log(f"[per-request-main] float32, prompts {lens} (rings of {RING_WINDOW}): per-request "
        f"first-token logits vs one batched cold round max |dlogit| {d:.3e} = {d / scale:.3e} x "
        f"logit scale {scale:.2f} (tol {tol:g} x scale); first-token argmax agreement "
        f"{agree:.2f}")
    del model32, params32, b, t, lb, lp
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    t_script = time.perf_counter()
    smi = phase_device()
    import torch

    dry = start_dryrun(ROOT / "build" / "dryrun")
    phase_build()
    t0 = time.perf_counter()
    phase_dryrun(smi, dry)
    log(f"[dryrun] wall after the build {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    recurrent_train_launches = phase_training_recurrent_isolated()
    log(f"[train-recurrent] phase 7g wall {time.perf_counter() - t0:.1f} s")
    # while this process holds little of the card: the examples' processes
    # need its memory (after phases 5-7f the allocator holds most of it)
    t0 = time.perf_counter()
    phase_dp_transmit(smi)
    log(f"[dp-transmit] wall {time.perf_counter() - t0:.1f} s")
    phase_examples(smi)
    rows = phase_kernels(smi)
    rows.update(phase_kernels_int8(smi))
    rows.update(phase_kernels_ring(smi))
    t0 = time.perf_counter()
    phase_kernels_verify(smi)
    log(f"[verify] phase 3d wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_kernels_tp(smi)
    log(f"[tp-kernels] phase 3e wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_kernels_shapes(smi)
    log(f"[shapes] phase 3f wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_kernels_hd256(smi)
    log(f"[hd256] phase 3g wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_kernels_whisper(smi)
    log(f"[whisper-kernels] phases 3w-3x, 5w wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_kernels_per_request(smi)
    log(f"[per-request] phases 3p, 2p wall {time.perf_counter() - t0:.1f} s")
    phase_golden()
    phase_golden_int8()
    phase_golden_ring()
    t0 = time.perf_counter()
    phase_golden_spec()
    log(f"[golden-spec] phase 4d wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_golden_router()
    log(f"[golden-router] phase 4e wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_golden_train()
    log(f"[golden-train] phase 4f wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_golden_tp()
    log(f"[tp-golden] phase 4g wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_golden_configs()
    log(f"[golden-configs] phase 4h wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_golden_recurrent()
    log(f"[golden-recurrent] phase 4i wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_golden_vlm_audio()
    log(f"[golden-vlm-audio] phase 4j wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_golden_per_request()
    log(f"[golden-per-request] phase 4k wall {time.perf_counter() - t0:.1f} s")
    launches, main_trace = phase_main_path(smi)
    t0 = time.perf_counter()
    phase_eos(smi, main_trace)
    spec = phase_spec_main(smi, main_trace)
    phase_sampling(smi, main_trace, spec)
    log(f"[spec-main] phases EOS, 5e and 5f wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_router_main(smi, main_trace)
    log(f"[router-main] phase 5i wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_lifecycle(smi, main_trace)
    log(f"[lifecycle] phase 5j wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tp_launches = phase_tp_main(smi, main_trace)
    log(f"[tp-main] phases 5k-5l wall {time.perf_counter() - t0:.1f} s")
    spec_launches = spec.pop("launches")
    batched = {k: main_trace[k] for k in ("record", "tokens", "tok_s", "ttft", "cold", "hits")}
    del main_trace, spec
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    config_launches = phase_configs_main(smi)
    log(f"[configs-main] phase 5m wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    recurrent_launches = phase_recurrent_main(smi)
    log(f"[recurrent-main] phase 5n wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    vlm_audio_launches = phase_vlm_audio_main(smi)
    log(f"[vlm-audio-main] phase 5o wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_train_vlm_audio(smi)
    log(f"[train-vlm-audio] wall {time.perf_counter() - t0:.1f} s")
    launches.update(phase_main_path_int8(smi))
    ring_launches, model, params, ring_batched = phase_main_path_ring(smi)
    launches.update(ring_launches)
    phase_serve_batch(smi, model, params)
    t0 = time.perf_counter()
    per_request_launches = phase_per_request_main(smi, model, params, batched, ring_batched)
    log(f"[per-request-main] phase 5p wall {time.perf_counter() - t0:.1f} s")
    del model, params, batched, ring_batched
    gc.collect()
    torch.cuda.empty_cache()
    phase_graph_fault(smi)
    rows.update(phase_channel_kernels(smi))
    t0 = time.perf_counter()
    train_launches = phase_training(smi)
    launches.update({k: train_launches[k] for k in CHANNEL})
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[train] phase 7 wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    model, params = phase_training_aggregators(smi)
    phase_microbatches(smi, model, params)
    phase_checkpoint(smi, params)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[train] phases 7b-7e wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_pod_train(smi)
    log(f"[pod-train] phase 7f wall {time.perf_counter() - t0:.1f} s")
    phase_first_sync_ties()
    check(not FAILED, f"{len(FAILED)} numeric checks failed: {FAILED}")
    log(f"[smoke] script wall {time.perf_counter() - t_script:.1f} s")
    # the speculative traces' launches: the verify's suffix prefills, the
    # draft's ring decode and re-sync prefills, the int8 verify's pool writes
    for k, c in spec_launches.items():
        if k in launches:
            launches[k] += c
    # the tensor-parallel traces' (5k-5l) and the other configs' (5m)
    for k, c in tp_launches.items():
        launches[k] += c
    for k, c in config_launches.items():
        launches[k] += c
    # the recurrent families' main paths (5n) and training (7g), pixtral's
    # and whisper's (5o), the per-request traces (5p)
    for k, c in (*recurrent_launches.items(), *recurrent_train_launches.items(),
                 *vlm_audio_launches.items(), *per_request_launches.items()):
        if k in launches:
            launches[k] += c
    kernels = []
    for name, r in rows.items():
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "wrapper_ms": r["wrapper_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
