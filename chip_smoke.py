#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mistralrs_tpu_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels-only [--port DIR]

Drives the port's main path on the card and checks it, in phases that each
print one progress line with the elapsed seconds. ``--kernels-only`` stops
after phase 2 and prints its rows as one JSON line; ``--port DIR`` imports
``mistralrs_tpu_torch`` from the tree at DIR (a ``git archive`` of another
commit, say), so that two versions of the kernels are timed by the same
script in one call:

0. watchdog and device: a hang ends in a traceback after 900 s; no CUDA
   device is an error; prints ``nvidia-smi``'s name and power limit;
1. build: compiles the CUDA kernels (one ``nvcc`` per source under
   ``csrc/``, all started together, then a link) and prints the build time;
2. kernels: each kernel against its plain PyTorch version at the main
   path's shapes (bf16), with its median time (CUDA events), its bound at
   the card's memory and bf16 tensor-core rates, the plain version's time
   and a PyTorch library call on the same inputs as a yardstick; beside the
   CUDA-event time of a call (host enqueue included, as the card waits for
   it), the device's own kernel time from a ``torch.profiler`` trace, for
   the kernel and for the library call alike. The dense matmul rows cycle
   through copies of the weight whose bytes exceed twice the L2 cache, as
   a decode step streams every weight once (the library's bf16 copies as
   well). W8 is timed at Llama-3-8B's Q8_0 head (M 1 and 8), a Q6_K-style
   down projection (M 8 and 512), and Mixtral-8x7B's Q8_0 ``attn_v`` (M 8
   and 512) and Q6_K head. The W4 and W8 kernels are also checked (untimed)
   at edge shapes: M
   of 1, 16, 17, 64 and 130, N a multiple of 16 but not of 64, K of one
   step, K splits that do not divide its steps evenly, no bias, f32 output,
   and for W8 its three byte formats (unsigned codes over all 256 values).
   The decode kernel is timed at B=8 (kv_lens up to 1024, one dropped
   write) and at depth, one request at 8192 positions and 8 at 4096 each
   (SDPA's yardstick, PyTorch's own choice of backend, takes no mask there:
   every position is visible), each
   call checked bit-equal to a second one and its pools equal to the plain
   version's but the trash slot.
   The prefill kernel is timed at B=2 T=128 on 300 cached positions and at
   the engine's chunks (4 x 256 tokens from position 0, 512 tokens on 512),
   and checked at GQA groups 1, 2, 4 and 8, blocks of 16, a row with no
   valid token and pasts not a multiple of 64; its pools must equal the
   plain version's but the trash slot, and a second call on the pools as
   they were must give the same bits. The
   grouped (MoE) kernels run on Mixtral-8x7B banks (8 experts, top-2) at
   n*k = 16 (decode, 8 tokens) and 1024 (a 512-token prefill) with routings
   drawn from the script's generator, plus one all-to-one routing and one
   with an empty expert; their bound counts the work the function needs:
   the planes of the experts the routing touches plus the n*k real rows of x
   and out (the padding rows of the used tiles are left out), and 2 * n*k *
   N * K operations; their library call is one ``torch.matmul`` per non-empty
   group on weights dequantized to bf16 ahead of time. The W4 and W8
   grouped kernels also run the all-to-one and empty-expert routings at both
   row tiles (16 and 64 rows). The dense grouped
   kernel also runs on DeepSeek-V2-Lite's expert banks (64 experts, top-6:
   gate/up [64, 2816, 2048], down [64, 2048, 1408]) at n*k = 36 (decode, 6
   tokens) and 1152 (a 2 x 96-token prefill), and, after every other row
   (so that the rows above keep the generator's stream of earlier runs), at
   phase 6's decode step of 1 token (n*k = 6): both bodies of
   ``dense_grouped_plan`` (each row names its body), each call checked
   bit-equal to a second one.
   The MLA decode kernel runs at
   DeepSeek-V2-Lite's shapes (16 heads, rank 512, rows of 576, batch 8) with
   16- and 64-token blocks, kv_lens from 0 to 2048, one dropped write (slot
   -1), one row with kv_len 0 and one write into the last block of its
   table, and, after every other row, at depth (one request at 8192
   positions, 8 at 4096 each, blocks of 64); the output, the written
   layer's pool (but its trash row, which the two dropped writes may tear)
   and the other layer are compared, and each call is checked bit-equal to
   a second one; its
   library call is ``scaled_dot_product_attention`` over the
   rows gathered ahead of time (values = rows[:, :512]), on the first backend
   that takes those shapes (no mask at depth, where every position is
   visible).
   Last, the paged kernels' quantized forms (int8 and fp8-e4m3 pools with
   bf16 scales): decode at the B=8 row above and at 8 x 4096, prefill at
   B=2 T=128 on 300 cached positions and at 512 tokens on 512; each against
   its plain version (2e-2; the pools' codes and scales bit-equal but at
   the trash slot, as bytes), a second call bit-equal, its bound counting
   the codes and bf16 scales it reads and writes, and SDPA on the K/V
   dequantized to bf16 and gathered ahead of time as its yardstick.
   Then the head_dim-256 forms at Gemma-2-9B's attention (16/8 heads,
   softcap 50): decode at the B=8 row above (a full layer), at 8 x 8192 with
   a 4096-position window (a sliding layer: its bound counts 4096 positions
   a row) and with a window of 100 (off the tile edge); prefill at B=2 T=128
   on 300 cached positions and 512 tokens on 3840 (the chunk passes the
   window's edge); and the head_dim-128 forms with Mistral-7B's
   4096-position window at 32/8 heads (decode at 8 x 8192, prefill 512 on
   3840). Each against its plain version (2e-2), a second call bit-equal,
   the pools equal but at the trash slot; SDPA's yardstick takes the window
   as a boolean mask and has no softcap.
   Then the head_dim-64 forms with sinks at gpt-oss-20b's attention (64/8
   heads, f32 sinks of N(6, 1) per head): decode at the B=8 row above and at
   8 x 8192 with its 128-position window, prefill at B=2 T=128 on 300 past
   and 512 tokens on 3840 with the window; the same checks, and on each row
   the plain version without the sinks must differ from it by more than 0.1
   (so a kernel that dropped them could not pass); SDPA's yardstick has no
   sinks. Then the dense grouped kernel on gpt-oss-20b's banks (32 experts,
   top-4: gate/up [32, 5760, 2880], down [32, 2880, 2880], K = 45 x 64) at
   n*k = 32 (8 decode tokens) and 2048 (a 512-token prefill). Last, the
   Qwen family: the prefill kernel at Qwen2.5-7B's heads (28/4, GQA group 7:
   9 tokens a 64-row query tile, its last row dead) at B=2 T=128 on 300 past
   and 512 tokens on 512, at group 5 (40/8, Qwen2.5-14B's) at B=2 T=128, its
   int8 form at group 7 at B=2 T=128; the decode kernel at group 7 at the
   table's row; and the dense grouped kernel on Qwen3-30B-A3B's banks (128
   experts, top-8: gate/up [128, 1536, 2048], down [128, 2048, 768]) at n*k
   = 48 (6 decode tokens) and 2048 (a 256-token chunk); the same checks.
   Last, the quantized forms (int8, then fp8) with every option: at
   Gemma-2-9B's attention (head_dim 256, softcap 50) decode at the table's
   row, at 8 x 8192 with the 4096 window and with a window of 100, prefill
   at B=2 T=128 on 300 past, with a window of 100 (untimed) and 512 on 3840
   through the window; at gpt-oss-20b's (head_dim 64, sinks) the shapes of
   its bf16 rows; the int8 form at head_dim 128 with Mistral-7B's window
   (decode 8 x 8192, prefill 512 on 3840); the same checks, and on the
   window-100 rows the plain version without the window must differ from
   it by more than 0.1 (the softcap's and the sinks' controls as above).
   Last, the W4 and W8 kernels' wide-group forms (groups of 64 and more),
   on layers drawn as GPTQ and AWQ checkpoints store them (int32 words, f16
   scales) and decoded on the device by ``quant/gptq_awq.py``: W4 at group
   128 at Llama-3.1-8B's shapes as its AWQ checkpoint stores them (M=8
   gate-up, o, qkv and down, M=512 gate-up), W8 at group 128 at
   Qwen2.5-7B-GPTQ-Int8's (M=8 gate-up N=37888 K=3584 and down K=18944,
   M=512 gate-up), timed as the group-32 rows are; then untimed edges: W4
   at group 64, W8 at 64 and per-column (g = K), K splits that cut groups,
   M of 1, 16, 17 and 130, bf16 and f32 output.
   Last, the grouped forms' wide groups (``w4_matmul_wide_g``,
   ``w8_matmul_wide_g``) on expert banks drawn as GPTQ and AWQ checkpoints
   store them, each expert decoded on the device and the experts stacked
   (``QTensor.stack``): Mixtral-8x7B's AWQ banks at group 128 (gate/up fused
   [8, 28672, 4096], down [8, 4096, 14336], both W4) at n*k = 16 and 1024,
   each beside a Q4_K bank of its shape (group 32) on the same routing and
   tokens; Qwen1.5-MoE-A2.7B's GPTQ-Int4 banks at group
   128 (W4 gate/up fused [60, 2816, 2048], W8 down [60, 2048, 1408] with
   unsigned codes and a bias) at n*k = 32 (8 decode tokens, top-4) and 2048
   (a 512-token prefill), timed as the group-32 rows are (bound: the
   touched experts' codes and f32 planes plus the n*k real rows; library:
   one ``torch.matmul`` per non-empty group); then untimed: those Qwen
   banks in the all-to-one and empty-expert routings at both row tiles, W4
   grouped at group 64, W8 grouped at 64 and per-column (g = K = 1408) in
   those routings at both row tiles, bf16 and f32 output, and the decode
   kernel at GQA group 1 (16/16 heads) at the table's B=8 row.
   Last, the GGUF forms on layers drawn as raw GGUF blocks on the device
   (``gguf/drawn.py``: weights centred on zero) and decoded there by the
   port's planarizers: W4 at group 16 (``w4_matmul_g16``: Q2_K's 2-bit
   codes in nibbles) at Qwen3-30B-A3B's ``attn_q`` (N 4096, K 2048) and
   ``attn_output`` (N 2048, K 4096), M 8 and 512, and over its fused
   gate/up bank (``w4_matmul_g16_g``: E 128, N 1536, K 2048, top-8) at n*k
   = 48 and 2048, timed as the group-32 rows are; untimed, W4 at group 16
   at the W4 rows' edge shapes (K of one step from planes drawn directly),
   the bank in the all-to-one and empty-expert routings at both row tiles
   and without a bias; W8 with unsigned codes and a bias at group 32 (Q5_K)
   at Qwen2.5-7B's gate-up (M 8) and down (M 8 and 512) and Q3_K banks
   (signed, group 16) at Qwen3-30B-A3B's down (E 128, N 2048, K 768) at
   n*k = 48 and 2048, timed; Q4_0, Q4_1 (W4 with a bias) and Q5_0, Q5_1
   (W8 unsigned with a bias) untimed at N = K = 4096, M 8 and 130.
   Then the paged kernels' head_dim-96 and -80 forms at Phi-3-mini's and
   Phi-2's attention (32/32 heads, group 1), timed: decode at B=8 (kv_lens
   up to 1024; every form, bf16, int8 and fp8), at 8 x 4096 with the 2047
   window (96) and at one request of 2048 positions (80), prefill at B=2
   T=128 on 300 past (every form), 512 tokens on 2048 past through the
   window (96) and 512 on 512 (80); untimed at each head dim, decode and
   prefill with a softcap and with sinks (each with its control) and at
   GQA group 8 (32/4 heads). Last, the contiguous path's prefill shapes at
   perplexity's 2048 rows (4 windows of 512), timed: W4 gate-up (N=28672
   K=4096) and down (N=4096 K=14336), and the Q8_0 head (W8, N=128256).
   Last, the weight formats at Llama-3.1-8B's gate-up (M 8 and 512) and
   down (M 8): FP8 weights through the W8 kernel's e4m3 form
   (``w8_matmul_e4m3``: the decode body at M 8, the prefill body at 512)
   at 128 x 128 block scales and at a per-tensor scale, and the same
   weights as HQQ-4 at group 64 on the W4 wide form, timed as the other
   W4/W8 rows are (bound: the codes and the f32 scale plane, and HQQ's
   bias plane); untimed, e4m3 at M 1 and 17 and at block 64;
3. model: ``forward_paged`` at full Llama-3-8B width with 2 layers, through
   the kernels and through the plain versions on the same device weights
   (a 2 x 96-token prefill, then 4 decode steps), logits compared; then the
   same over int8 and over fp8 pools (the quantized forms launched, no
   plain version in the kernel run);
3b. the same at full Mixtral-8x7B width with 2 layers: layer 0 holds Q4_K
   gate/up and a Q6_K down bank, layer 1 Q4_K gate/up and a bf16 down bank,
   so all three grouped kernels run. Both paths record the experts each
   (token, layer) chose; near-tied router logits may pick differently under
   the two sum orders, so at least 99 % of the choices must agree. The plain
   run then takes the kernel run's choices (its own router weights at those
   experts), so every row's logits at every step are compared;
3c. the same at full DeepSeek-V2-Lite width with 2 layers (the dense layer
   0 and one MoE layer of 64 bf16 experts, top-6, 2 shared), bf16 weights:
   the MLA decode kernel at every decode step, the dense grouped kernel on
   the routed experts; the same rule on expert choices; then through the
   kernels over an int8 latent pool, on the bf16 run's expert choices: the
   gather path at every step (no MLA launch), logits within 5e-2 of the
   largest of the bf16 pool's;
3d. the same at full Gemma-2-9B width with 2 layers (layer 0 sliding with
   its 4096-position window, layer 1 full; both softcaps; head_dim 256),
   bf16 weights: a 4160-token prompt in 512-token chunks and a 100-token
   one, then 4 decode steps of both; logits within 5e-2 of the largest;
   over bf16, int8 and fp8 pools;
3e. the same at full gpt-oss-20b width with 2 layers (layer 0 sliding with
   its 128-position window, layer 1 full; sinks, q/k/v/o biases, YaRN,
   head_dim 64, 32 bf16 experts top-4 with biases and the clamped SwiGLU):
   two 300-token prompts in 128-token chunks, then 4 decode steps; phase
   3b's rule on expert choices (>= 99 % agree, then the plain run takes the
   kernel run's choices); logits within 5e-2 of the largest; then over int8
   and fp8 pools on the bf16 kernel run's expert choices (as 3c's int8
   latent pool: a 1-byte cache quantizes the two paths' slightly different
   K/V rows to codes a step apart, which flips more near-ties, 24 of 1216
   at int8 where bf16 pools flip 12). Phases 3b, 3e
   and 3g log, beside the count of expert choices that agree, the plain
   run's router-logit gap at the top-k edge (the k-th largest logit less the
   (k+1)-th) of each choice that differs: near-ties flip under another sum
   order, a kernel fault would flip clear choices too; beside them, how far
   the two runs' router logits lie apart (on one path: the plain run takes
   the kernel run's choices), in bf16 ulps of each row's top-k edge;
3f. the same schedule at full Qwen2.5-7B width with 2 layers (GQA group 7,
   q/k/v biases; each 128-token chunk spans 15 query tiles of 9 tokens),
   bf16 weights; logits within 5e-2 of the largest;
3g. the same at full Qwen3-30B-A3B width with 2 layers (q/k norm, q_dim 4096
   against a hidden 2048, 128 bf16 experts top-8 on the dense grouped
   kernel); its bf16 router logits tie at the top-8 edge in about one
   (token, layer) in fifty, so in place of phase 3b's 99 % every expert
   choice that differs must be a near-tie, the plain run's gap at most
   ``NEAR_TIE_ULPS`` bf16 ulps of the 8th logit (a kernel fault that flips
   a clear choice fails it), then the plain run on the kernel run's
   choices;
3h. the same schedule at full Gemma-3-27B width with 2 layers (layer 0
   sliding, window 1024, with the local rope base 10^4; layer 1 full with
   the global base 10^6 and linear scaling 8; head_dim 128, 32/16 heads, a
   scale of 168^-0.5, q/k norms), over fp8 pools; logits within 5e-2 of the
   largest, and the same weights with the two rope bases swapped must move
   the kernel run's logits by more than ten times the kernels' worst
   difference from the plain run (both relative to the largest logit);
3i. the phase-3f schedule at full Qwen2.5-7B width with 2 layers as its
   GPTQ-Int4 and then its GPTQ-Int8 checkpoint stores them (group 128,
   symmetric v1 zeros, f16 q/k/v biases, embedding and head), drawn on the
   device and loaded through the HF loader (``weights_from_state_dict``),
   q/k/v fused with their biases: the W4 and then the W8 wide-group form
   in both bodies, no plain version in the kernel run; logits within 5e-2
   of the largest;
3j. the phase-3f schedule at full Qwen1.5-MoE-A2.7B width with 2 layers as
   its GPTQ-Int4 checkpoint stores them (16/16 heads with q/k/v biases, 60
   experts top-4 without renormalisation, the gated shared expert; group
   128; f16 routers and shared-expert gates), drawn on the device a layer
   at a time and loaded through the HF loader: W4 grouped (gate/up) and W8
   grouped (down) in both bodies, the W4 wide form for attention and the
   shared expert, no plain version in the kernel run; phase 3g's near-tie
   rule on expert choices, then the plain run on the kernel run's choices;
   logits within 5e-2 of the largest;
3k. the same at full Mixtral-8x7B width with 2 layers as TheBloke's AWQ
   checkpoint stores them (group 128, zero points, f16 router): W4 grouped
   for both banks in both bodies; phase 3b's rule on expert choices;
3l. the planarizers: a 2048 x 4096 tensor of every planar type drawn on
   the device, its codes, scales and biases decomposed there bit-equal to
   the CPU's decomposition of the same bytes; then the phase-3f schedule
   at full Qwen2.5-7B width with 2 layers as its Q5_K_M GGUF stores them
   (layer 0 Q5_K, layer 1's ``attn_v`` and ``ffn_down`` Q6_K, a Q6_K head,
   a Q5_K embedding; q/k/v biases) and at full Qwen3-30B-A3B width as a
   Q2_K-mix GGUF (Q2_K attention q/k/o, gate/up banks and embedding, Q3_K
   ``attn_v`` and down banks, a Q6_K head; q/k norms), each drawn on the
   device as ``load_gguf_model`` reads it (``gguf/drawn.py``'s
   ``DrawnGGUF``) and decoded there: W8 (Q5_K, Q6_K) in both bodies, and
   W4 at group 16 dense and grouped and W8 dense and grouped in both
   bodies, no plain version in the kernel run; phase 3g's near-tie rule on
   Qwen3's expert choices; logits within 5e-2 of the largest;
3m. in-situ quantization (ISQ): a 1024 x 4096 tensor quantized on the card
   to each ISQ type (Q8_0, Q4_0, Q5_0, Q4_K, Q5_K, Q6_K; Q4_K also with
   importance weights) must give the CPU's bytes for the same input (its
   card time per million weights logged); then the phase-3f schedule at
   full Mixtral-8x7B and Qwen1.5-MoE-A2.7B width with 2 layers each, drawn
   on the device as bf16 checkpoints and quantized to Q4_K at load
   (``weights_from_state_dict(isq=Q4_K)``: the routers padded to 16 and 64
   rows on W4, the expert banks on W4 grouped, Qwen1.5-MoE's down bank at
   K = 1408 left bf16 on the dense grouped kernel, its shared expert and
   gate on W4, Q8_0 heads on W8): W4 and W4 grouped in both bodies, no
   plain version in the kernel run; phase 3b's rule on Mixtral's expert
   choices, phase 3g's near-tie rule on Qwen1.5-MoE's with its threshold
   twice the largest router-logit difference of the two runs on one path
   (at least 4 ulps: a quantized router's product is taken on f32
   weights by the kernel, on bf16-rounded ones by the plain version);
   logits within 5e-2 of the largest;
3n. the Llama-family variants: the phase-3f schedule at full width with 2
   layers of each of Phi-3-mini-4k-instruct, Phi-2 (both over bf16, int8
   and fp8 pools), StarCoder2-7B, StableLM-2-1.6B, Aya-23-8B,
   Granite-3.1-8B, GLM-4-9B-0414 and SmolLM3-3B (its second layer a NoPE
   one), each from its published ``config.json`` through the port's
   ``config_from_hf``, drawn on the device as a bf16 HF checkpoint under
   the arch's own tensor names (phi3's fused ``qkv_proj``/``gate_up_proj``,
   phi2's ``dense``/``fc1``/``fc2`` and ``final_layernorm``, LayerNorm and
   MLP biases, glm4's sandwich norms) and loaded through the HF loader: the
   paged forms of the arch's head dim launched (80 and 96 for the Phis) and
   no plain version; logits within 5e-2 of the largest;
3o. the contiguous-cache forward (``models/llama.py::forward``) at full
   width with 2 layers of Llama-3-8B (Q4_K, a Q8_0 head) and Mixtral-8x7B
   Q4_K_M (a Q6_K and a Q4_K down bank) over ``KVCache`` (a 512-token
   prefill in chunks of 256, 4 decode steps), and of Gemma-2-9B in bf16
   over ``HybridKVCache`` (a 4400-token prompt in chunks of 1024: the
   sliding layer's 4096-slot ring wraps; 4 decode steps): through the
   kernels, through the plain versions, and through ``forward_paged`` on
   the same weights and tokens (Mixtral's two other runs on the kernel
   run's expert choices); every step's logits within 5e-2 of the largest
   of the kernel run's (``contiguous_runs``), the W4/W8 (and grouped)
   kernels launched and no plain version in the kernel runs;
3p. the weight formats at full Llama-3.1-8B width with 2 layers, drawn on
   the card as a bf16 checkpoint and written to a temporary directory as
   a bf16 HF directory, an NF4 one (bitsandbytes' tensors, double-quantized
   scales, codes made on the card by ``quant/bnb.py``) and a mistral.rs
   UQFF file of the projections at Q4_K (``save_reference_uqff``): two NF4
   weights decoded on the card must equal the CPU's decode bit for bit;
   then the phase-3f schedule (``two_layer_runs``) on the NF4 directory
   loaded with ISQ Q4_K, and with ISQ Q8_0 under a ``Topology`` of Q2_K
   (layer 0) and Q3_K (layer 1), on the bf16 directory with the UQFF
   overlay (``from_uqff=``), and on the CLI's ``quantize`` of the bf16
   directory to a Q4_K ``.gguf`` read by ``load_gguf_model``: W4, W4 at
   group 16 and W8 launched, no plain version in the kernel runs, logits
   within 5e-2 of the largest;
4. serve: the full 32-layer Llama-3-8B geometry with random Q4_K/Q8_0
   planes drawn on the device, behind the port's HTTP server on 127.0.0.1;
   6 concurrent chat requests (40-600 prompt tokens, one streamed, half
   greedy, half seeded sampling), every kernel's launch count read after the
   run (a replay of the captured decode step counts the launches its graph
   recorded), then the server and engine threads are shut down and joined.
   Then, on the same engine, 6 requests (3 greedy, 3 seeded sampled) past
   their first decode step: from one saved state (KV pools, sampling
   state), 8 decode steps through the step function run eagerly and 8
   through the captured graph, the logits bit-equal and the tokens
   identical; the first replay with its staging under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync up to the one
   result wait); the step's wall time, device kernel time and idle share
   through the graph and eagerly side by side; and one engine step timed on
   the host clock and traced with ``torch.profiler`` for the device's
   kernel time, its idle share, the kernels that take most of it and the
   device time of the W4 (decode body, 8-row tile), W4 grouped (decode
   body, 16-row tile), W8 (decode body, 8-row tile), W8 grouped (decode
   body, 16-row tile), dense grouped (both bodies), paged decode and MLA
   decode kernels. Then the same weights serve again from int8 KV pools
   (``Engine(kv_quant="int8")``): the same 6 requests of 12 tokens each,
   the quantized decode and prefill forms launched and no plain version
   run, and the same graph checks (the saved state holds the scale planes
   too);
5. serve the full 32-layer Mixtral-8x7B geometry (about 39 GB, drawn on the
   device after the Llama weights are freed) in llama.cpp's Q4_K_M recipe:
   Q4_K attention and gate/up banks, Q6_K down banks on the 16
   ``use_more_bits`` layers and Q4_K on the rest, Q8_0 ``attn_v``, a Q6_K
   head, a bf16 embedding and router; the same 6 requests and checks;
6. serve the full 27-layer DeepSeek-V2-Lite geometry (bf16, ~29 GiB drawn on
   the device after the Mixtral weights are freed) through the engine's
   DeepSeek adapter: the same 6 requests and checks, the MLA decode and
   dense grouped kernels launched and no plain version run;
7. serve the full 42-layer Gemma-2-9B geometry (bf16, ~18.5 GB drawn on the
   device after the DeepSeek weights are freed; 192 KV blocks of 64
   positions, ~4.2 GB): the same 6 requests but one prompt of 4400 tokens,
   so that its positions pass 4096 and the sliding layers' windows bite in
   prefill and in decode; the same checks; the head_dim-256 forms of the
   paged kernels launched and no plain version run;
8. serve the full 24-layer gpt-oss-20b geometry (bf16, ~41.8 GB drawn on
   the device after the Gemma weights are freed; its MXFP4 expert banks as
   the loader decodes them, to bf16): the same 6 requests (40-600 prompt
   tokens: the 128-position windows bite in prefill and in decode) and
   checks; the head_dim-64 forms of the paged kernels and the dense grouped
   kernel launched and no plain version run;
9. serve the full 28-layer Qwen2.5-7B geometry (bf16, ~15.2 GB drawn on the
   device after the gpt-oss weights are freed; q/k/v biases, GQA group 7):
   the same 6 requests (the 600-token prompt runs 3 prefill chunks of many
   group-7 query tiles) and checks; the paged kernels launched and no plain
   version run;
10. serve the full 48-layer Qwen3-30B-A3B geometry (bf16, ~61.1 GB drawn on
   the device after the Qwen2.5 weights are freed; q/k norm, 128 experts
   top-8): the same 6 requests and checks; the paged kernels and the dense
   grouped kernel on the 128-expert banks launched and no plain version run;
11. serve the full 48-layer Gemma-3-12B geometry (bf16, ~23.5 GB drawn on
   the device after the Qwen3 weights are freed; head_dim 256, five sliding
   layers of six with a 1024 window and the local rope base, linear
   scaling 8 on the global base, q/k norms) from int8 KV pools (160 blocks
   of 64 positions): the same 6 requests but one prompt of 2500 tokens,
   over 10 prefill chunks and past the window; the same checks; the int8
   head_dim-256 forms of the paged kernels launched and no plain version;
12. serve the full 32-layer Llama-3.1-8B geometry (llama3 rope scaling) as
   hugging-quants' AWQ INT4 checkpoint stores it (gemm packing, group 128,
   zero points; ~6.0 GB on the device: 3.93 GB of W4 planes, 2.1 GB of
   embedding and head), drawn on the device and loaded through the HF
   loader: the same 6 requests and checks; the W4 wide-group form launched
   in both bodies and no plain version;
13. serve the full 24-layer Qwen1.5-MoE-A2.7B geometry as its GPTQ-Int4
   checkpoint stores it (~11 GB on the device: 9.1 GB of expert planes, the
   shared experts, attention, a bf16 embedding and head), drawn on the
   device a layer at a time as the loader reads it (the words of one layer
   at a time beside the planes) after the Llama-3.1 weights are freed: the
   same 6 requests and checks; W4 grouped and W8 grouped launched in both
   bodies, the W4 wide form, and no plain version;
14. serve the full 28-layer Qwen2.5-7B-Instruct geometry as its Q5_K_M
   GGUF file stores it (llama.cpp's recipe: Q5_K, Q6_K for ``attn_v`` and
   ``ffn_down`` on the 14 ``use_more_bits`` layers and for the head, a
   Q5_K embedding; F32 norms and q/k/v biases), drawn on the device as
   ``load_gguf_model`` reads it (its seconds and sizes logged) after the
   Qwen1.5-MoE weights are freed: the same 6 requests and checks; W8
   launched in both bodies and no plain version;
15. serve the full 48-layer Qwen3-30B-A3B geometry as a Q2_K-mix GGUF file
   stores it (phase 3l's mix; ~31 GiB of planes, its peak logged), drawn
   on the device as the loader reads it after the Qwen2.5 weights are
   freed: the same 6 requests and checks; W4 at group 16 dense and grouped
   in both bodies, W8 and W8 grouped, and no plain version;
16. serve the full 32-layer Llama-3.1-8B geometry drawn on the device as a
   bf16 checkpoint (~16.1 GB) and quantized in situ to Q4_K at load, with a
   Q8_0 embedding and head (the ISQ seconds, the weights quantized, the
   planes' size and the peak device memory logged) after the Qwen3 weights
   are freed: the same 6 requests and checks; W4 in both bodies and W8
   launched, no plain version;
17. serve the full 32-layer Phi-3-mini-4k-instruct geometry (~7.6 GB
   drawn on the device as a bf16 HF checkpoint and loaded through the HF
   loader, its fused projections split at load and fused again) after the
   Llama-3.1 weights are freed: the same 6 requests but one prompt of 2500
   tokens (160 KV blocks of 64 positions), past its 2047 window in prefill
   and in decode; the same checks; the head_dim-96 forms launched and no
   plain version; then the same weights from int8 KV pools (its int8
   head_dim-96 forms);
18. serve the full 32-layer Phi-2 geometry drawn as a bf16 checkpoint and
   quantized in situ to Q4_K at load (Q8_0 embedding and head; its biases
   and LayerNorms dense): the same 6 requests and checks; W4 in both
   bodies, W8 and the head_dim-80 forms launched, no plain version;
19. the calibration loop on the 32-layer Llama-3.1-8B geometry drawn as a
   bf16 checkpoint (as phase 16): an importance matrix collected in f32
   over 4 drawn batches of 512 tokens (``ImatrixCollector``; the f32 copy
   freed after), written and read back; ISQ to Q4_K without and with it
   (their codes must differ); ``compute_perplexity`` (window 512, batch 4,
   8 windows) of the bf16, Q4_K and Q4_K+imatrix models, finite (drawn
   weights and tokens: the values mean nothing), the Q4_K run through the
   W4/W8 kernels and no plain version; one batch through the kernels
   against the plain versions (logits within 5e-2 of the largest); one
   traced batch (wall, device ms, idle share, W4/W8 device ms and
   launches); ``generate`` of 32 greedy tokens (ms a token, an eager
   decode step's idle share); ``embed`` of 8 prompts; under 600 s;
20. serve the 32-layer Llama-3.1-8B geometry drawn as a bf16 checkpoint,
   its projections quantized on the card to HQQ-4 at group 64 (the
   embedding and head bf16), fused, written with ``save_uqff`` to a
   temporary directory (~6 GiB) and loaded back through ``load_pipeline``
   of the ``.uqff`` file (the HQQ, write and read seconds and the file's
   size logged; the file deleted); its 32 layers through the kernels and
   the plain versions (logits within 5e-2 of the largest), then the same 6
   requests and checks; the W4 wide form launched in both bodies and no
   plain version;
21. serve the 32-layer Llama-3.1-8B geometry with its projections in
   blockwise FP8 (128 x 128 scales, quantized on the card; the embedding
   and head bf16): the same 6 requests and checks, the e4m3 form launched
   in both bodies and no plain version; then 2 layers of it written with
   ``save_uqff`` and read back with ``load_uqff`` bit for bit, through the
   kernels and the plain versions;
22. constrained decoding and the text routes: the 32-layer Llama-3-8B
   geometry of phase 4 (Q4_K, drawn on the device) served with a tokenizer
   of Llama-3's 128256 ids (:class:`VocabTokenizer`: ids 0-255 single bytes,
   the rest 1-12-byte strings drawn from the seed), 8 requests at once on
   ``/v1/chat/completions`` and ``/v1/completions`` (two ``json_object``,
   one ``json_schema``, one regex, one choice, one Lark grammar, one with
   DRY and logprobs, one plain completion) while ``/v1/messages``,
   ``count_tokens``, ``/v1/responses`` (POST, then GET and DELETE),
   ``/v1/embeddings``, ``/metrics`` and ``/v1/system/info`` are called:
   each constrained output stays inside its recognizer (a JSON object that
   parses, or a live prefix where it stopped on length), every route's
   JSON checked, W4/W8 and the paged kernels launched and no plain
   version; the host ms per mask of each constraint kind; a second model
   (a 2-layer Llama-geometry Q4_K GGUF written to the temporary directory)
   loaded through ``/v1/models/load`` and served beside the 8B, each giving
   the greedy text it gives alone, a load whose split state would have to
   grow under the 8B's graphs refused (400), the unload giving the device
   memory back (``memory_allocated`` within 1 % of its value before the
   load), load and unload seconds; then, on the engine with 0, 1 and 8
   JSON-constrained rows of 8, 8 decode steps from one saved state eagerly
   and through the graph, with the host's mask updates between them, must
   give bit-equal logits and tokens, and one engine step's wall time beside
   the device's kernel time in a trace of the next step (its idle share);
23. the last line: ``{"ok": true, "device": {...}}``. A failed phase raises
   and the script exits non-zero without that line.

The ``kernels`` line gives each kernel's launches summed over the runs of
its path, and each run's count beside them (``launches_by_run``): the serve
phases 4-18 (4's int8 serve and 11 for the int8 forms of the paged
kernels), the phase-3 model runs for their fp8 forms (3, 3d, 3e, 3h, 3n)
and the int8 head_dim-64 forms (3e), phase 3i's two runs (the W8
wide-group form runs there alone), phases 3j, 3k, 3l, 3m, 3n, 3o and
3p, phase 19's Q4_K perplexity run, the serves of phases 20 and 21,
phase 21's 2-layer run (the e4m3 form runs in phase 21 alone) and phase
22's constrained serve; a kernel launched
in none fails the
run; and its times at the main path's dominant shape
(``library_device_ms``: the library call's own device time).

Budget: the whole run at most 10 minutes on an H100 with the build (the
int8 serve and the quantized rows add about half a minute, phase 19 at
most 600 s of it, phase 22 at most 90 s), at most 8 GB of host memory
(8e9 bytes of peak RSS, checked at the end: all weights are drawn on the device, none on the host;
phases 3p and 20 move their files between the card and the disk in 64 MiB
chunks, GGUF and UQFF blocks included), at most
72 GB of device memory (phase 10's Qwen3-30B-A3B weights take 61.1 GB, its
KV pools 0.8 GB; phase 19's bf16 checkpoint and its f32 copy about 48 GB),
and about 7 GB of files in the temporary directory at a time (phase 3p).

Tolerances: the W8 prefill body (W8 and W8 grouped at more than 16 rows a
tile) and the dense grouped kernel use the plain version's weights exactly
and differ in f32 sum order; the decode body (W4 and W8 at
row tiles of <= 16 rows) never rounds the weight to bf16 (scale and bias
applied to f32 group sums) and the W4 prefill body computes each weight
within an f32 ulp before the plain version's rounding, so all of them agree
with the plain versions within 1e-2 of the largest |value|; the attention kernels agree within
2e-2 absolute (bf16 outputs of magnitude ~1, exp2 vs exp, sum order, and P
as two bf16 parts for the decode and prefill kernels' tensor-core PV
products); the
models' logits agree within 5e-2 of the largest |logit| (bf16 activations
through two full-width layers). The MLA decode kernel rounds P to bf16 for
its tensor-core PV product and sums in another order: 2e-2 absolute on
bf16 outputs of magnitude ~1; the pool after the write is exact; it merges
its splits in split order, so two calls give the same bits.
"""

from __future__ import annotations

import collections.abc
import contextlib
import faulthandler
import gc
import itertools
import json
import math
import os
import resource
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

faulthandler.dump_traceback_later(900, exit=True)

KERNELS_ONLY = "--kernels-only" in sys.argv
if "--port" in sys.argv:
    sys.path.insert(0, sys.argv[sys.argv.index("--port") + 1])

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mistralrs_tpu_torch import cli, embeddings, perplexity  # noqa: E402
from mistralrs_tpu_torch.chat_template import resolve_chat_template  # noqa: E402
from mistralrs_tpu_torch.engine.adapters import DeepseekAdapter  # noqa: E402
from mistralrs_tpu_torch.engine.engine import Engine, decode_widths, forward_rows  # noqa: E402,E501
from mistralrs_tpu_torch.engine.sampler import SamplingParams  # noqa: E402
from mistralrs_tpu_torch.generate import generate  # noqa: E402
from mistralrs_tpu_torch.gguf import planar as gguf_planar  # noqa: E402
from mistralrs_tpu_torch.gguf.constants import GGMLType, type_traits  # noqa: E402
from mistralrs_tpu_torch.gguf.drawn import (  # noqa: E402
    DrawnGGUF,
    draw_blocks,
    gguf_metadata,
    llama_family_tensors,
)
from mistralrs_tpu_torch.gguf.quants import quantize  # noqa: E402
from mistralrs_tpu_torch.imatrix import ImatrixCollector, load_imatrix, save_imatrix  # noqa: E402,E501
from mistralrs_tpu_torch.kv.paged import (  # noqa: E402
    CODE_DTYPES,
    PagedKVCache,
    gather_kv,
    quantize_rows,
)
from mistralrs_tpu_torch.models.config import (  # noqa: E402
    ModelConfig,
    config_from_gguf,
    config_from_hf,
)
from mistralrs_tpu_torch.models import deepseek, hf_loader, llama  # noqa: E402
from mistralrs_tpu_torch.models.gguf_loader import load_gguf_model  # noqa: E402
from mistralrs_tpu_torch.models.llama import forward_paged  # noqa: E402
from mistralrs_tpu_torch.ops import _cuda  # noqa: E402
from mistralrs_tpu_torch.ops import moe_grouped as _moe_grouped  # noqa: E402
from mistralrs_tpu_torch.ops.mla_attention import mla_decode  # noqa: E402
from mistralrs_tpu_torch.ops.moe_grouped import (  # noqa: E402
    build_groups,
    dense_matmul_grouped,
    grouped_tile,
)
from mistralrs_tpu_torch.ops.paged_attention import (  # noqa: E402
    paged_decode_attention_fused,
    paged_prefill_attention_fused,
)
from mistralrs_tpu_torch.ops.quant_matmul import (  # noqa: E402
    quant_matmul,
    quant_matmul_grouped,
)
from mistralrs_tpu_torch.perplexity import compute_perplexity  # noqa: E402
from mistralrs_tpu_torch.pipeline import load_pipeline  # noqa: E402
from mistralrs_tpu_torch.quant import bnb, gptq_awq  # noqa: E402
from mistralrs_tpu_torch.quant.fp8 import Fp8Tensor  # noqa: E402
from mistralrs_tpu_torch.quant.hqq import hqq_quantize  # noqa: E402
from mistralrs_tpu_torch.quant.qtensor import QTensor  # noqa: E402
from mistralrs_tpu_torch.topology import Topology  # noqa: E402
from mistralrs_tpu_torch.uqff import load_uqff, save_reference_uqff, save_uqff  # noqa: E402
from mistralrs_tpu_torch.serving.server import Server  # noqa: E402
from mistralrs_tpu_torch.tokenizer import Detokenizer  # noqa: E402

T0 = time.monotonic()
SEED = 0
HOST_BUDGET = 8e9  # bytes of host memory the run may hold at its peak (module docstring)

# Llama-3-8B geometry (bench.py:103-115 of the JAX package)
LLAMA3_8B = dict(
    arch="llama", vocab_size=128256, hidden_size=4096, intermediate_size=14336,
    num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
    rope_theta=500000.0, max_position_embeddings=8192, rms_norm_eps=1e-5,
)

# Mixtral-8x7B (mistralai/Mixtral-8x7B-Instruct-v0.1 config.json)
MIXTRAL_8X7B = dict(
    arch="mixtral", vocab_size=32000, hidden_size=4096, intermediate_size=14336,
    num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128, rope_theta=1e6,
    max_position_embeddings=32768, rms_norm_eps=1e-5, num_experts=8,
    num_experts_per_tok=2, moe_intermediate_size=14336,
)
# DeepSeek-V2-Lite (deepseek-ai/DeepSeek-V2-Lite config.json; its YaRN
# rope_scaling entry is left out, as both packages ignore it)
DEEPSEEK_V2_LITE = dict(
    vocab_size=102400, hidden_size=2048, intermediate_size=10944, moe_intermediate_size=1408,
    num_layers=27, num_heads=16, q_lora_rank=None, kv_lora_rank=512, qk_rope_head_dim=64,
    qk_nope_head_dim=128, v_head_dim=128, n_routed_experts=64, num_experts_per_tok=6,
    n_shared_experts=2, first_k_dense_replace=1, rms_norm_eps=1e-6, rope_theta=10000.0,
    routed_scaling_factor=1.0, scoring_func="softmax", norm_topk_prob=False, n_group=1,
    topk_group=1, max_position_embeddings=163840,
)
# Gemma-2-9B (google/gemma-2-9b config.json; tie_word_embeddings set, as the
# checkpoint has no lm_head.weight)
GEMMA2_9B = dict(
    arch="gemma2", vocab_size=256000, hidden_size=3584, intermediate_size=14336, num_layers=42,
    num_heads=16, num_kv_heads=8, head_dim=256, sliding_window=4096, attn_logit_softcap=50.0,
    logit_softcap=30.0, attn_scale=256 ** -0.5, rms_norm_eps=1e-6, rope_theta=10000.0,
    max_position_embeddings=8192, hidden_act="gelu_pytorch_tanh", tie_word_embeddings=True,
)
# gpt-oss-20b (openai/gpt-oss-20b config.json: 24 layers alternating sliding
# and full, window 128, YaRN, attention biases and sinks, 32 experts top-4
# with the clamped SwiGLU; its MXFP4 expert banks drawn here in bf16)
GPT_OSS_20B = dict(
    arch="gpt_oss", vocab_size=201088, hidden_size=2880, intermediate_size=2880, num_layers=24,
    num_heads=64, num_kv_heads=8, head_dim=64, num_experts=32, num_experts_per_tok=4,
    sliding_window=128, layer_types=["sliding_attention", "full_attention"] * 12,
    rope_theta=150000.0, attention_bias=True, rms_norm_eps=1e-5,
    rope_scaling={"rope_type": "yarn", "factor": 32.0, "beta_fast": 32.0, "beta_slow": 1.0,
                  "original_max_position_embeddings": 4096, "truncate": False},
    max_position_embeddings=131072,
)
# Qwen2.5-7B-Instruct (Qwen/Qwen2.5-7B-Instruct config.json: 28 query heads on
# 4 KV heads, GQA group 7; q/k/v biases; its sliding_window of 131072 windows
# every layer, as both packages read the config, and never bites)
QWEN25_7B = dict(
    arch="qwen2", vocab_size=152064, hidden_size=3584, intermediate_size=18944, num_layers=28,
    num_heads=28, num_kv_heads=4, head_dim=128, sliding_window=131072, rms_norm_eps=1e-6,
    rope_theta=1e6, max_position_embeddings=32768,
)
# Qwen3-30B-A3B (Qwen/Qwen3-30B-A3B config.json: 32 query heads on 4 KV heads,
# head_dim 128 so q_dim 4096 against a hidden 2048, q/k norm, 128 bf16
# experts top-8 of width 768, renormalised)
QWEN3_30B_A3B = dict(
    arch="qwen3moe", vocab_size=151936, hidden_size=2048, intermediate_size=6144, num_layers=48,
    num_heads=32, num_kv_heads=4, head_dim=128, qk_norm=True, num_experts=128,
    num_experts_per_tok=8, moe_intermediate_size=768, norm_topk_prob=True, rms_norm_eps=1e-6,
    rope_theta=1e6, max_position_embeddings=40960,
)
# Gemma-3-12B (the text_config of google/gemma-3-12b-it's config.json, with
# Gemma3TextConfig's defaults: head_dim 256, query_pre_attn_scalar 256,
# rope_theta 1e6, rope_local_base_freq 1e4, vocab 262208, a tied head; its
# layer pattern slides on all but every sixth layer, window 1024)
GEMMA3_12B = dict(
    arch="gemma3", vocab_size=262208, hidden_size=3840, intermediate_size=15360, num_layers=48,
    num_heads=16, num_kv_heads=8, head_dim=256, sliding_window=1024, attn_scale=256 ** -0.5,
    rms_norm_eps=1e-6, rope_theta=1e6, rope_local_theta=1e4, qk_norm=True,
    rope_scaling={"rope_type": "linear", "factor": 8.0}, hidden_act="gelu_pytorch_tanh",
    tie_word_embeddings=True, max_position_embeddings=131072,
)
# Gemma-3-27B (google/gemma-3-27b-it's text_config: 62 layers, head_dim 128,
# 32 query heads on 16 KV heads, query_pre_attn_scalar 168)
GEMMA3_27B = dict(GEMMA3_12B, hidden_size=5376, intermediate_size=21504, num_layers=62,
                  num_heads=32, num_kv_heads=16, head_dim=128, attn_scale=168 ** -0.5)
# Llama-3.1-8B-Instruct as hugging-quants/Meta-Llama-3.1-8B-Instruct-AWQ-INT4
# ships it (its config.json: llama3 rope scaling, factor 8, on Llama-3-8B's
# geometry; AWQ gemm, 4 bits, group 128, zero_point; f16 embedding and an
# untied f16 head, cast to bf16 by the loader)
LLAMA31_8B = dict(LLAMA3_8B, max_position_embeddings=131072,
                  rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                                "high_freq_factor": 4.0,
                                "original_max_position_embeddings": 8192})
AWQ_INT4 = {"quant_method": "awq", "bits": 4, "group_size": 128, "zero_point": True,
            "version": "gemm"}
# Qwen/Qwen2.5-7B-Instruct-GPTQ-Int4 and -Int8's quantization_config: group 128,
# sym, no act-order, v1 zeros (stored less 1)
GPTQ_INT4 = {"quant_method": "gptq", "bits": 4, "group_size": 128, "sym": True,
             "desc_act": False}
GPTQ_INT8 = dict(GPTQ_INT4, bits=8)
# Qwen1.5-MoE-A2.7B as Qwen/Qwen1.5-MoE-A2.7B-Chat-GPTQ-Int4 ships it (its
# config.json: 16/16 heads of 128, q/k/v biases, 60 experts top-4 of width
# 1408 without renormalisation, a gated shared expert of 5632, rope_theta
# 1e6; its sliding_window of 32768 windows every layer, as both packages
# read the config, and never bites at 8192 positions; quantization_config
# GPTQ_INT4's, the routers and shared-expert gates left f16): the experts'
# gate/up (K = 2048) land on W4 grouped, their down (K = 1408, K/2 % 128 =
# 64) keeps a byte a code and lands on W8 grouped, attention and the shared
# expert on W4, all at group 128
QWEN15_MOE_A27B = dict(
    arch="qwen2moe", vocab_size=151936, hidden_size=2048, intermediate_size=5632,
    num_layers=24, num_heads=16, num_kv_heads=16, head_dim=128, num_experts=60,
    num_experts_per_tok=4, moe_intermediate_size=1408, shared_expert_intermediate_size=5632,
    norm_topk_prob=False, sliding_window=32768, rms_norm_eps=1e-6, rope_theta=1e6,
    max_position_embeddings=8192,
)
DENSE_KERNELS = ("w4_matmul", "w8_matmul", "paged_decode", "paged_prefill")
WIDE_W4_KERNELS = ("w4_matmul_wide", "paged_decode", "paged_prefill")
WIDE_W8_KERNELS = ("w8_matmul_wide", "paged_decode", "paged_prefill")
DEEPSEEK_KERNELS = ("mla_decode", "dense_matmul_g")
GEMMA_KERNELS = ("paged_decode_hd256", "paged_prefill_hd256")
GPT_OSS_KERNELS = ("paged_decode_hd64", "paged_prefill_hd64", "dense_matmul_g")
QWEN_KERNELS = ("paged_decode", "paged_prefill")
QWEN_MOE_KERNELS = ("paged_decode", "paged_prefill", "dense_matmul_g")
# the wide-group grouped forms: GPTQ/AWQ expert banks
QWEN15_MOE_KERNELS = ("w4_matmul_wide_g", "w8_matmul_wide_g", "w4_matmul_wide", "paged_decode",
                      "paged_prefill")
MIXTRAL_AWQ_KERNELS = ("w4_matmul_wide_g", "w4_matmul_wide", "paged_decode", "paged_prefill")
# GGUF files: Qwen2.5-7B in Q5_K_M (W8 unsigned with a bias at group 32, Q6_K
# on W8 signed at group 16), Qwen3-30B-A3B in a Q2_K mix (W4 at group 16,
# dense and grouped; Q3_K attn_v and down banks and a Q6_K head on W8)
GGUF_Q5KM_KERNELS = ("w8_matmul", "paged_decode", "paged_prefill")
GGUF_Q2K_KERNELS = ("w4_matmul_g16", "w4_matmul_g16_g", "w8_matmul", "w8_matmul_g",
                    "paged_decode", "paged_prefill")

# bf16 checkpoints quantized in situ to Q4_K at load: W4 (attention, the
# padded routers, qwen2moe's shared expert and gate), W4 grouped (the expert
# banks; qwen2moe's down bank at K = 1408 stays bf16 on the dense grouped
# kernel), W8 (the Q8_0 head)
ISQ_TYPES = ("Q8_0", "Q4_0", "Q5_0", "Q4_K", "Q5_K", "Q6_K")
ISQ_MOE_KERNELS = ("w4_matmul", "w4_matmul_g", "w8_matmul", "paged_decode", "paged_prefill")

# the Llama-family variants: their published config.json files (the keys the
# readers take), read by the port's own config_from_hf
VARIANT_JSON = {
    # microsoft/Phi-3-mini-4k-instruct: 32/32 heads of 96, fused qkv_proj and
    # gate_up_proj, a window of 2047
    "phi3": {"architectures": ["Phi3ForCausalLM"], "hidden_act": "silu", "hidden_size": 3072,
             "intermediate_size": 8192, "max_position_embeddings": 4096,
             "num_attention_heads": 32, "num_hidden_layers": 32, "num_key_value_heads": 32,
             "rms_norm_eps": 1e-05, "rope_scaling": None, "rope_theta": 10000.0,
             "sliding_window": 2047, "tie_word_embeddings": False, "vocab_size": 32064},
    # microsoft/phi-2: 32/32 heads of 80, partial rotary 0.4, LayerNorm with
    # biases, parallel residual, gelu_new, biased gateless MLP, lm_head bias
    "phi2": {"architectures": ["PhiForCausalLM"], "hidden_act": "gelu_new",
             "hidden_size": 2560, "intermediate_size": 10240, "layer_norm_eps": 1e-05,
             "max_position_embeddings": 2048, "num_attention_heads": 32,
             "num_hidden_layers": 32, "num_key_value_heads": 32, "partial_rotary_factor": 0.4,
             "qk_layernorm": False, "rope_theta": 10000.0, "tie_word_embeddings": False,
             "vocab_size": 51200},
    # bigcode/starcoder2-7b: 36/4 heads (group 9), gateless biased MLP,
    # LayerNorm with biases, a window of 4096
    "starcoder2": {"architectures": ["Starcoder2ForCausalLM"],
                   "hidden_act": "gelu_pytorch_tanh", "hidden_size": 4608,
                   "intermediate_size": 18432, "max_position_embeddings": 16384,
                   "norm_epsilon": 1e-05, "num_attention_heads": 36, "num_hidden_layers": 32,
                   "num_key_value_heads": 4, "rope_theta": 1000000, "sliding_window": 4096,
                   "use_bias": True, "vocab_size": 49152},
    # stabilityai/stablelm-2-1_6b: 32/32 heads of 64, partial rotary 0.25,
    # q/k/v biases, LayerNorm with biases
    "stablelm": {"architectures": ["StableLmForCausalLM"], "hidden_act": "silu",
                 "hidden_size": 2048, "intermediate_size": 5632, "layer_norm_eps": 1e-05,
                 "max_position_embeddings": 4096, "num_attention_heads": 32,
                 "num_hidden_layers": 24, "num_key_value_heads": 32,
                 "partial_rotary_factor": 0.25, "rope_theta": 10000,
                 "tie_word_embeddings": False, "use_qkv_bias": True, "vocab_size": 100352},
    # CohereForAI/aya-23-8B (cohere): 32/8 heads, interleaved rope, parallel
    # residual, LayerNorm without biases, logit_scale 0.125, a tied head
    "cohere": {"architectures": ["CohereForCausalLM"], "hidden_act": "silu",
               "hidden_size": 4096, "intermediate_size": 14336, "layer_norm_eps": 1e-05,
               "logit_scale": 0.125, "max_position_embeddings": 8192,
               "num_attention_heads": 32, "num_hidden_layers": 32, "num_key_value_heads": 8,
               "rope_theta": 10000, "use_qk_norm": False, "vocab_size": 256000,
               "tie_word_embeddings": True},
    # ibm-granite/granite-3.1-8b-instruct: embedding 12, residual 0.22,
    # attention 0.0078125, logits 16, vocab 49155, a tied head
    "granite": {"architectures": ["GraniteForCausalLM"], "attention_multiplier": 0.0078125,
                "embedding_multiplier": 12.0, "hidden_act": "silu", "hidden_size": 4096,
                "intermediate_size": 12800, "logits_scaling": 16.0,
                "max_position_embeddings": 131072, "num_attention_heads": 32,
                "num_hidden_layers": 40, "num_key_value_heads": 8, "residual_multiplier": 0.22,
                "rms_norm_eps": 1e-05, "rope_theta": 10000000.0, "tie_word_embeddings": True,
                "vocab_size": 49155},
    # THUDM/GLM-4-9B-0414: 32/2 heads (group 16), partial rotary 0.5
    # interleaved, sandwich norms, q/k/v biases, fused gate_up_proj
    "glm4": {"architectures": ["Glm4ForCausalLM"], "attention_bias": True, "head_dim": 128,
             "hidden_act": "silu", "hidden_size": 4096, "intermediate_size": 13696,
             "max_position_embeddings": 32768, "num_attention_heads": 32,
             "num_hidden_layers": 40, "num_key_value_heads": 2, "partial_rotary_factor": 0.5,
             "rms_norm_eps": 1e-05, "rope_theta": 10000.0, "tie_word_embeddings": False,
             "vocab_size": 151552},
    # HuggingFaceTB/SmolLM3-3B: 16/4 heads, NoPE every fourth layer, a tied head
    "smollm3": {"architectures": ["SmolLM3ForCausalLM"], "hidden_act": "silu",
                "hidden_size": 2048, "intermediate_size": 11008,
                "max_position_embeddings": 65536, "no_rope_layers": [
                    0 if (i + 1) % 4 == 0 else 1 for i in range(36)],
                "num_attention_heads": 16, "num_hidden_layers": 36, "num_key_value_heads": 4,
                "rms_norm_eps": 1e-06, "rope_theta": 5000000.0, "sliding_window": None,
                "tie_word_embeddings": True, "use_sliding_window": False,
                "vocab_size": 128256},
}
PHI3_KERNELS = ("paged_decode_hd96", "paged_prefill_hd96")
PHI2_KERNELS = ("paged_decode_hd80", "paged_prefill_hd80")
PHI2_ISQ_KERNELS = ("w4_matmul", "w8_matmul") + PHI2_KERNELS

# memory rate (B/s) and dense bf16 tensor-core rate (FLOP/s) by card
# (NVIDIA data sheets; the rates assume the card's full power limit)
RATES = {"H100 PCIe": (2.0e12, 756e12), "H100 NVL": (3.9e12, 835e12),
         "H100": (3.35e12, 989e12), "H200": (4.8e12, 989e12)}

# (the paged kernels' bodies: paged_attention.cuh, compiled one head dim a source)
KERNEL_INFO = {
    "w4_matmul": ("mistralrs_tpu_torch/csrc/w4_matmul.cu",
                  "mistralrs_tpu/ops/quant_matmul.py:350"),
    "w8_matmul": ("mistralrs_tpu_torch/csrc/w8_matmul.cu",
                  "mistralrs_tpu/ops/quant_matmul.py:411"),
    # the wide-group forms (groups of 64 and more: GPTQ, AWQ, per-column)
    "w4_matmul_wide": ("mistralrs_tpu_torch/csrc/w4_matmul.cu",
                       "mistralrs_tpu/ops/quant_matmul.py:350"),
    "w8_matmul_wide": ("mistralrs_tpu_torch/csrc/w8_matmul.cu",
                       "mistralrs_tpu/ops/quant_matmul.py:411"),
    "paged_decode": ("mistralrs_tpu_torch/csrc/paged_attention.cuh",
                     "mistralrs_tpu/ops/paged_attention.py:496"),
    "paged_prefill": ("mistralrs_tpu_torch/csrc/paged_attention.cuh",
                      "mistralrs_tpu/ops/paged_attention.py:1162"),
    "w4_matmul_g": ("mistralrs_tpu_torch/csrc/w4_matmul.cu",
                    "mistralrs_tpu/ops/quant_matmul.py:830"),
    "w8_matmul_g": ("mistralrs_tpu_torch/csrc/w8_matmul.cu",
                    "mistralrs_tpu/ops/quant_matmul.py:895"),
    # the grouped forms' wide groups (GPTQ and AWQ expert banks)
    "w4_matmul_wide_g": ("mistralrs_tpu_torch/csrc/w4_matmul.cu",
                         "mistralrs_tpu/ops/quant_matmul.py:830"),
    "w8_matmul_wide_g": ("mistralrs_tpu_torch/csrc/w8_matmul.cu",
                         "mistralrs_tpu/ops/quant_matmul.py:895"),
    # W4 at group 16 (Q2_K), dense and over a bank
    "w4_matmul_g16": ("mistralrs_tpu_torch/csrc/w4_matmul.cu",
                      "mistralrs_tpu/ops/quant_matmul.py:350"),
    "w4_matmul_g16_g": ("mistralrs_tpu_torch/csrc/w4_matmul.cu",
                        "mistralrs_tpu/ops/quant_matmul.py:830"),
    # the e4m3 form (FP8 weights): JAX fp8_matmul, computed by XLA there
    "w8_matmul_e4m3": ("mistralrs_tpu_torch/csrc/w8_matmul.cu",
                       "mistralrs_tpu/quant/fp8.py:84"),
    "dense_matmul_g": ("mistralrs_tpu_torch/csrc/dense_grouped.cu",
                       "mistralrs_tpu/ops/moe_grouped.py:67"),
    "mla_decode": ("mistralrs_tpu_torch/csrc/mla_attention.cu",
                   "mistralrs_tpu/ops/mla_attention.py:218"),
    # the quantized forms of the paged kernels (the JAX kernels' quantized=True)
    "paged_decode_int8": ("mistralrs_tpu_torch/csrc/paged_attention.cuh",
                          "mistralrs_tpu/ops/paged_attention.py:496"),
    "paged_decode_fp8": ("mistralrs_tpu_torch/csrc/paged_attention.cuh",
                         "mistralrs_tpu/ops/paged_attention.py:496"),
    "paged_prefill_int8": ("mistralrs_tpu_torch/csrc/paged_attention.cuh",
                           "mistralrs_tpu/ops/paged_attention.py:1162"),
    "paged_prefill_fp8": ("mistralrs_tpu_torch/csrc/paged_attention.cuh",
                          "mistralrs_tpu/ops/paged_attention.py:1162"),
    # the head_dim-256 instances of the bf16 forms (Gemma-2)
    "paged_decode_hd256": ("mistralrs_tpu_torch/csrc/paged_attention.cuh",
                           "mistralrs_tpu/ops/paged_attention.py:496"),
    "paged_prefill_hd256": ("mistralrs_tpu_torch/csrc/paged_attention.cuh",
                            "mistralrs_tpu/ops/paged_attention.py:1162"),
    # the head_dim-64 instances of the bf16 forms (gpt-oss)
    "paged_decode_hd64": ("mistralrs_tpu_torch/csrc/paged_attention.cuh",
                          "mistralrs_tpu/ops/paged_attention.py:496"),
    "paged_prefill_hd64": ("mistralrs_tpu_torch/csrc/paged_attention.cuh",
                           "mistralrs_tpu/ops/paged_attention.py:1162"),
    # the quantized forms at head_dim 256 and 64 (Gemma, gpt-oss)
    **{f"paged_{k}_{q}_hd{d}": ("mistralrs_tpu_torch/csrc/paged_attention.cuh",
                                "mistralrs_tpu/ops/paged_attention.py:"
                                + ("496" if k == "decode" else "1162"))
       for k in ("decode", "prefill") for q in ("int8", "fp8") for d in (256, 64)},
    # every form at head_dim 80 and 96 (Phi-2, Phi-3-mini)
    **{f"paged_{k}{q}_hd{d}": ("mistralrs_tpu_torch/csrc/paged_attention.cuh",
                               "mistralrs_tpu/ops/paged_attention.py:"
                               + ("496" if k == "decode" else "1162"))
       for k in ("decode", "prefill") for q in ("", "_int8", "_fp8") for d in (80, 96)},
}
QUANT_KERNELS = ("w4_matmul", "w8_matmul", "paged_decode_int8", "paged_prefill_int8")


def log(msg: str) -> None:
    if msg.startswith("phase "):  # each phase's first line: where host memory stands
        msg += f" [{host_rss()}]"
    print(f"[{time.monotonic() - T0:7.1f}s] {msg}", flush=True)


def host_rss() -> str:
    """The process's resident host memory now and at its peak so far, in GB
    (1e9 bytes)."""
    now = 0
    with contextlib.suppress(OSError), open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                now = int(line.split()[1])  # KiB
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss  # KiB
    return f"host RSS {now * 1024 / 1e9:.2f} GB (peak {peak * 1024 / 1e9:.2f} GB)"


def check(cond: bool, msg: str) -> None:
    """A result check that holds under ``python -O`` too."""
    if not cond:
        raise AssertionError(msg)


def card_rates(name: str) -> tuple[float, float]:
    """The card's published rates; an unknown card is bounded with the H100
    SXM's (the log line of phase 0 shows which were used)."""
    for key in ("H100 PCIe", "H100 NVL", "H200", "H100"):
        if key in name:
            return RATES[key]
    return RATES["H100"]


def bound(nbytes: float, flops: float, rates) -> tuple[float, str]:
    t_mem, t_ops = nbytes / rates[0], flops / rates[1]
    return (max(t_mem, t_ops) * 1e3, "bytes" if t_mem >= t_ops else "operations")


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median of CUDA-event times of single calls, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_kernels(prof) -> dict:
    """``{kernel name: (device µs, launches)}`` of a ``torch.profiler`` run."""
    from torch.autograd import DeviceType

    return {e.key: (e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def device_ms(fn, iters: int = 10):
    """The device's kernel time per call of ``fn`` (all its kernels, no host
    time), from a ``torch.profiler`` trace of ``iters`` calls; None when no
    kernel of the trace has a record for every call (records lost)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(5):  # a trace now and then loses its records: try again, longer
        n_calls = iters * (1 + attempt)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n_calls):
                fn()
            torch.cuda.synchronize()
        kernels = device_kernels(prof).values()
        if kernels and max(n for _, n in kernels) >= n_calls:
            return sum(us for us, _ in kernels) / n_calls / 1e3
    return None


def fmt_ms(v) -> str:
    return "not measured" if v is None else f"{v:.4f} ms"


# ---------------------------------------------------------------------------
# random planar weights, drawn on the device
# ---------------------------------------------------------------------------


def q4k(n: int, k: int, gen: torch.Generator, dev, e: int | None = None) -> QTensor:
    """Random Q4_K-style planes (a bank of ``e`` experts when given): 4-bit
    codes, group 32, zero-mean weights (bias = -8 scale) of variance ~1/K so
    activations keep their scale."""
    lead = () if e is None else (e,)
    data = torch.randint(0, 256, (*lead, k // 2, n), generator=gen, device=dev,
                         dtype=torch.uint8)
    scale = (0.75 + 0.5 * torch.rand((*lead, k // 32, n), generator=gen, device=dev)
             ) / math.sqrt(21.25 * k)
    return QTensor(data, scale, -8.0 * scale, group_size=32, packed=True, code_bits=4)


def q8(n: int, k: int, gen: torch.Generator, dev, gs: int = 32, lo: int = -127,
       hi: int = 127, e: int | None = None) -> QTensor:
    """Random signed planes, codes in [lo, hi], no bias: Q8_0 at the
    defaults, Q6_K-style with gs 16 and codes in [-32, 31]."""
    lead = () if e is None else (e,)
    data = torch.randint(lo, hi + 1, (*lead, k, n), generator=gen, device=dev, dtype=torch.int8)
    var = ((hi - lo + 1) ** 2 - 1) / 12 + ((hi + lo) / 2) ** 2  # E[q^2]
    scale = (0.75 + 0.5 * torch.rand((*lead, k // gs, n), generator=gen, device=dev)
             ) / math.sqrt(k * var)
    return QTensor(data, scale, None, group_size=gs, packed=False,
                   code_bits=8 if hi == 127 else 6)


def q6k(n: int, k: int, gen: torch.Generator, dev, e: int | None = None) -> QTensor:
    """Q6_K-style planes: signed codes in [-32, 31], group 16, no bias."""
    return q8(n, k, gen, dev, gs=16, lo=-32, hi=31, e=e)


def widened(n: int, k: int, gen: torch.Generator, dev, e: int) -> QTensor:
    """A Q4_K bank in the JAX loader's widened form: int8 codes in [0, 15],
    group 16, with a bias plane (the signed-with-bias W8 format)."""
    data = torch.randint(0, 16, (e, k, n), generator=gen, device=dev, dtype=torch.int8)
    scale = (0.75 + 0.5 * torch.rand((e, k // 16, n), generator=gen, device=dev)
             ) / math.sqrt(21.25 * k)
    return QTensor(data, scale, -7.5 * scale, group_size=16, packed=False, code_bits=8)


def bf16_bank(n: int, k: int, gen: torch.Generator, dev, e: int) -> torch.Tensor:
    """A dense bf16 expert bank [E, N, K] of variance 1/K."""
    return (torch.randn((e, n, k), generator=gen, device=dev) / math.sqrt(k)).to(torch.bfloat16)


def quant_words(n: int, k: int, gen: torch.Generator, dev, bits: int = 4, group: int = 128,
                awq: bool = False) -> dict:
    """One projection ``[n, k]`` as a GPTQ (symmetric: zeros stored as
    2^(bits-1) - 1, read with v1's + 1) or AWQ (``zero_point``: zeros drawn)
    checkpoint stores it, drawn on the device: int32 ``qweight`` and
    ``qzeros``, f16 ``scales`` giving weights of variance ~1/K, and for
    GPTQ a trivial ``g_idx``; ``group`` 0 is per-column (g = K). AWQ's
    words lie over the whole 32-bit range (codes and zeros uniform, so
    ``q - z`` has mean 0). GPTQ's codes are uniform over 1 .. 2^bits - 1,
    centred on the symmetric zero 2^(bits-1) as the codes of zero-mean
    weights are (the words still reach bit 31): codes over every value
    would give every weight a mean of half a step, a common-mode term that
    each 4-bit product of K inputs multiplies by ~sqrt(K) / 9, so that two
    layers of it lift activations ~20x and peak the attention until
    last-bit differences move its output."""
    g = group or k
    per, levels = 32 // bits, 1 << bits

    def words(*shape):
        return torch.randint(-2**31, 2**31, shape, generator=gen, device=dev,
                             dtype=torch.int64).to(torch.int32)

    def centred_words(*shape):  # codes uniform over 1 .. levels - 1, packed along dim 0
        codes = torch.randint(1, levels, (per, *shape), generator=gen, device=dev,
                              dtype=torch.int64)
        w = sum(codes[i] << (i * bits) for i in range(per))
        return (w - ((w >> 31) << 32)).to(torch.int32)  # as the int32 the checkpoint holds

    if awq:
        out = {"qweight": words(k, n // per), "qzeros": words(k // g, n // per)}
        e2 = (levels * levels - 1) / 6  # E[(q - z)^2], both uniform over every value
    else:
        word = sum((levels // 2 - 1) << (i * bits) for i in range(per))
        out = {"qweight": centred_words(k // per, n),
               "qzeros": torch.full((k // g, n // per), word, dtype=torch.int32, device=dev),
               "g_idx": torch.arange(k, dtype=torch.int32, device=dev) // g}
        e2 = ((levels - 1) ** 2 - 1) / 12  # the codes' variance about the zero
    out["scales"] = ((0.75 + 0.5 * torch.rand((k // g, n), generator=gen, device=dev))
                     / math.sqrt(e2 * k)).to(torch.float16)
    return out


def wide_layer(n: int, k: int, gen: torch.Generator, dev, bits: int = 4, group: int = 128,
               awq: bool = False, zero_offset: int = 1) -> QTensor:
    """:func:`quant_words` decoded on the device by ``quant/gptq_awq.py``."""
    w = quant_words(n, k, gen, dev, bits, group, awq)
    if awq:
        return gptq_awq.awq_to_qtensor(w["qweight"], w["qzeros"], w["scales"])
    return gptq_awq.gptq_to_qtensor(w["qweight"], w["qzeros"], w["scales"], g_idx=w["g_idx"],
                                    bits=bits, zero_offset=zero_offset)


def quant_bank(e: int, n: int, k: int, gen: torch.Generator, dev, bits: int = 4,
               group: int = 128, awq: bool = False) -> QTensor:
    """A bank of ``e`` experts ``[n, k]``, each drawn as a GPTQ or AWQ
    checkpoint stores it (:func:`quant_words`), decoded on the device by
    ``quant/gptq_awq.py`` one by one and stacked (``QTensor.stack``), as the
    HF loader builds a bank; a fused gate/up bank is drawn as one ``[2 I,
    H]`` layer an expert (both formats pack columns independently, so the
    planes equal those of gate and up decoded apart and concatenated)."""
    return QTensor.stack([wide_layer(n, k, gen, dev, bits, group, awq) for _ in range(e)])


def checkpoint_layer(cfg: ModelConfig) -> dict:
    """The tensors of one layer of a checkpoint of ``cfg``: ``{suffix:
    ("words", (n, k)) | ("f16", shape, std) | ("ones", shape)}``; every
    projection (q/k/v/o, the dense MLP, Mixtral's and qwen2moe's experts,
    qwen2moe's shared expert) as words in a GPTQ or AWQ checkpoint (a bf16
    ``[n, k]`` weight in a dense one, :func:`bf16_checkpoint`), the norms
    of ones, Qwen's q/k/v biases of N(0, 0.1^2), the routers and qwen2moe's
    shared-expert gate in f16 of N(0, 1/H) (AutoGPTQ and AutoAWQ leave them
    unquantized). The Llama-family variants' layers under their own HF names
    (:data:`VARIANT_JSON`): phi3's fused ``qkv_proj`` and ``gate_up_proj``
    (glm4's ``gate_up_proj``), phi2's ``dense``, ``fc1``, ``fc2`` and
    starcoder2's ``c_fc``, ``c_proj`` with their biases of N(0, 0.02^2), q/k/v
    biases of N(0, 0.1^2) where the arch has them, LayerNorm biases of N(0,
    0.02^2), no post-attention norm with a parallel residual, glm4's
    sandwich norms."""
    h, i = cfg.hidden_size, cfg.intermediate_size
    norms = ("input_layernorm",) + (() if cfg.parallel_residual
                                    else ("post_attention_layernorm",))
    spec = {f"{norm}.weight": ("ones", (h,)) for norm in norms}
    if cfg.arch in ("phi2", "starcoder2", "stablelm"):  # LayerNorm with biases
        spec.update({f"{norm}.bias": ("f16", (h,), 0.02) for norm in norms})
    o_proj = "self_attn.dense" if cfg.arch == "phi2" else "self_attn.o_proj"
    if cfg.arch == "phi3":
        projs = {"self_attn.qkv_proj": (cfg.q_dim + 2 * cfg.kv_dim, h), o_proj: (h, cfg.q_dim)}
    else:
        projs = {"self_attn.q_proj": (cfg.q_dim, h), "self_attn.k_proj": (cfg.kv_dim, h),
                 "self_attn.v_proj": (cfg.kv_dim, h), o_proj: (h, cfg.q_dim)}
    e, mi = cfg.num_experts, cfg.moe_intermediate_size or i
    if cfg.arch == "mixtral":
        spec["block_sparse_moe.gate.weight"] = ("f16", (e, h), h ** -0.5)
        for j in range(e):
            projs.update({f"block_sparse_moe.experts.{j}.w1": (mi, h),
                          f"block_sparse_moe.experts.{j}.w3": (mi, h),
                          f"block_sparse_moe.experts.{j}.w2": (h, mi)})
    elif cfg.arch == "qwen2moe":
        si = cfg.shared_expert_intermediate_size
        spec["mlp.gate.weight"] = ("f16", (e, h), h ** -0.5)
        spec["mlp.shared_expert_gate.weight"] = ("f16", (1, h), h ** -0.5)
        for j in range(e):
            projs.update({f"mlp.experts.{j}.gate_proj": (mi, h),
                          f"mlp.experts.{j}.up_proj": (mi, h),
                          f"mlp.experts.{j}.down_proj": (h, mi)})
        projs.update({"mlp.shared_expert.gate_proj": (si, h),
                      "mlp.shared_expert.up_proj": (si, h),
                      "mlp.shared_expert.down_proj": (h, si)})
    elif cfg.arch in ("phi2", "starcoder2"):  # gateless, biased
        up, down = ("mlp.fc1", "mlp.fc2") if cfg.arch == "phi2" else ("mlp.c_fc", "mlp.c_proj")
        projs.update({up: (i, h), down: (h, i)})
        spec.update({f"{up}.bias": ("f16", (i,), 0.02), f"{down}.bias": ("f16", (h,), 0.02),
                     f"{o_proj}.bias": ("f16", (h,), 0.02)})
    elif cfg.arch in ("phi3", "glm4"):
        projs.update({"mlp.gate_up_proj": (2 * i, h), "mlp.down_proj": (h, i)})
    else:
        projs.update({"mlp.gate_proj": (i, h), "mlp.up_proj": (i, h), "mlp.down_proj": (h, i)})
    spec.update({name: ("words", nk) for name, nk in projs.items()})
    if cfg.arch in ("qwen2", "qwen2moe", "phi2", "starcoder2", "stablelm", "glm4"):
        for t in "qkv":
            spec[f"self_attn.{t}_proj.bias"] = ("f16", (projs[f"self_attn.{t}_proj"][0],), 0.1)
    if cfg.arch == "glm4":
        spec.update({f"{norm}.weight": ("ones", (h,))
                     for norm in ("post_self_attn_layernorm", "post_mlp_layernorm")})
    return spec


class LayerwiseCheckpoint(collections.abc.Mapping):
    """A GPTQ or AWQ checkpoint of ``cfg`` (``quantization_config`` ``qc``)
    drawn on the device a layer at a time, as the HF loader reads it: its
    names are known up front, and a layer's tensors are drawn (from a
    generator of that layer's own seed) when one of them is first read,
    and the layer before dropped, so that the int32 words of the whole
    model never sit on the device beside the planes decoded from them. The
    embedding and the untied head are f16 of N(0, 0.02^2), the final norm
    ones."""

    def __init__(self, cfg: ModelConfig, dev, seed: int, qc: dict):
        self.cfg, self.dev, self.seed, self.qc = cfg, dev, seed, qc
        self.spec = checkpoint_layer(cfg)
        parts = ("qweight", "qzeros", "scales") + (() if qc["quant_method"] == "awq"
                                                   else ("g_idx",))
        self.names = {}  # name → (layer, suffix, part)
        for li in range(cfg.num_layers):
            for suffix, kind in self.spec.items():
                if kind[0] == "words":
                    for part in parts:
                        self.names[f"model.layers.{li}.{suffix}.{part}"] = (li, suffix, part)
                else:
                    self.names[f"model.layers.{li}.{suffix}"] = (li, suffix, None)
        gen = torch.Generator(device=dev).manual_seed(seed)
        h, v = cfg.hidden_size, cfg.vocab_size
        self.top = {"model.embed_tokens.weight": self._f16(gen, (v, h), 0.02),
                    "model.norm.weight": torch.ones(h, device=dev, dtype=torch.float16),
                    "lm_head.weight": self._f16(gen, (v, h), 0.02)}
        self.layer, self.tensors = None, {}

    def _f16(self, gen, shape, std):
        return torch.randn(shape, generator=gen, device=self.dev, dtype=torch.float16).mul_(std)

    def _draw(self, li: int) -> None:
        self.tensors = {}  # the layer before is dropped first
        gen = torch.Generator(device=self.dev).manual_seed(self.seed + 7919 * (li + 1))
        qc = self.qc
        for suffix, kind in self.spec.items():
            if kind[0] == "words":
                n, k = kind[1]
                words = quant_words(n, k, gen, self.dev, qc["bits"], qc["group_size"],
                                    qc["quant_method"] == "awq")
                self.tensors.update({(suffix, part): t for part, t in words.items()})
            elif kind[0] == "f16":
                self.tensors[(suffix, None)] = self._f16(gen, kind[1], kind[2])
            else:
                self.tensors[(suffix, None)] = torch.ones(kind[1], device=self.dev,
                                                          dtype=torch.float16)
        self.layer = li

    def __getitem__(self, name):
        if name in self.top:
            return self.top[name]
        li, suffix, part = self.names[name]
        if li != self.layer:
            self._draw(li)
        return self.tensors[(suffix, part)]

    def __contains__(self, name):  # a name's layer is drawn only when it is read
        return name in self.top or name in self.names

    def __iter__(self):
        return itertools.chain(self.top, self.names)

    def __len__(self):
        return len(self.top) + len(self.names)


def build_quantized(cfg: ModelConfig, dev, seed: int, qc: dict) -> dict:
    """``cfg``'s weights as a GPTQ or AWQ checkpoint (``quantization_config``
    ``qc``) stores them (:class:`LayerwiseCheckpoint`: a layer's words drawn
    on the device as the loader reads it), loaded through the HF loader
    (``weights_from_state_dict``: the words decoded on the device into
    planar QTensors, the experts stacked into banks, the f16 tensors cast
    to bf16), then q/k/v, gate/up and the experts' gate/up fused: ~6.0 GB
    for Llama-3.1-8B's 32 layers at 4 bits, ~11 GB for Qwen1.5-MoE-A2.7B's
    24."""
    sd = LayerwiseCheckpoint(cfg, dev, seed, qc)
    weights = hf_loader.weights_from_state_dict(sd, cfg, device=dev, quant_config=qc)
    del sd
    torch.cuda.empty_cache()
    return llama.fuse_projections(weights, cfg)


def bf16_checkpoint(cfg: ModelConfig, dev, seed: int) -> dict:
    """``cfg``'s weights as a dense bf16 Hugging Face checkpoint (its tensor
    names, :func:`checkpoint_layer`'s tensors) drawn on the device: each
    projection ``[n, k]`` of N(0, 1/k), the routers and qwen2moe's
    shared-expert gates of N(0, 1/H), Qwen's q/k/v biases of N(0, 0.1^2),
    norms of ones, the embedding and an untied head of N(0, 0.02^2):
    ~16.1 GB for Llama-3.1-8B; the variants' layers as
    :func:`checkpoint_layer` names them, phi2's ``final_layernorm`` and
    ``lm_head.bias`` (N(0, 0.02^2)), a LayerNorm arch's final norm bias:
    ~7.6 GB for Phi-3-mini."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(shape, std):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16).mul_(std)

    h, v = cfg.hidden_size, cfg.vocab_size
    final = "model.final_layernorm" if cfg.arch == "phi2" else "model.norm"
    sd = {"model.embed_tokens.weight": draw((v, h), 0.02),
          f"{final}.weight": torch.ones(h, device=dev, dtype=torch.bfloat16)}
    if cfg.arch in ("phi2", "starcoder2", "stablelm"):
        sd[f"{final}.bias"] = draw((h,), 0.02)
    if not cfg.tie_word_embeddings:
        sd["lm_head.weight"] = draw((v, h), 0.02)
    if cfg.arch == "phi2":
        sd["lm_head.bias"] = draw((v,), 0.02)
    spec = checkpoint_layer(cfg)
    for li in range(cfg.num_layers):
        for suffix, kind in spec.items():
            name = f"model.layers.{li}.{suffix}"
            if kind[0] == "words":
                n, k = kind[1]
                sd[name + ".weight"] = draw((n, k), k ** -0.5)
            elif kind[0] == "f16":
                sd[name] = draw(kind[1], kind[2])
            else:
                sd[name] = torch.ones(kind[1], device=dev, dtype=torch.bfloat16)
    return sd


def quantized_weights(tree) -> int:
    """The weights of a weight tree held as planes (a padded matrix counts
    its ``logical_n`` rows)."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        return sum(quantized_weights(t) for t in tree)
    if isinstance(tree, QTensor):
        *lead, n, k = tree.shape
        return (tree.logical_n or n) * k * math.prod(lead)
    return 0


def build_isq(cfg: ModelConfig, dev, seed: int, stats: dict | None = None) -> dict:
    """``cfg``'s weights as a bf16 checkpoint (:func:`bf16_checkpoint`)
    quantized in situ to Q4_K as the HF loader reads it
    (``weights_from_state_dict(isq=Q4_K)``: on the device, embedding and
    head to Q8_0, routers and gates padded to 16 rows, tensors whose K is
    not a multiple of 256 left bf16), then q/k/v, gate/up and the experts'
    gate/up fused. Logs the ISQ seconds (drawing excluded), the weights
    quantized, the planes' size and the peak device memory so far; puts
    them in ``stats`` when given."""
    sd = bf16_checkpoint(cfg, dev, seed)
    torch.cuda.synchronize()
    drawn = torch.cuda.memory_allocated(dev)
    t0 = time.monotonic()
    weights = hf_loader.weights_from_state_dict(sd, cfg, device=dev, isq=GGMLType.Q4_K)
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    n = quantized_weights(weights)
    info = {"seconds": dt, "weights": n, "ms_per_million": dt * 1e3 / (n / 1e6),
            "bf16_gib": drawn / 2**30,
            "planes_gib": (torch.cuda.memory_allocated(dev) - drawn) / 2**30,
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    log(f"  ISQ to Q4_K at load: {n / 1e9:.3f} G weights quantized in {dt:.2f} s "
        f"({info['ms_per_million']:.3f} ms per million weights); {info['bf16_gib']:.2f} GiB "
        f"allocated with the bf16 checkpoint drawn, {info['planes_gib']:.2f} GiB of planes "
        f"beside it, peak so far {info['peak_gib']:.2f} GiB")
    if stats is not None:
        stats.update(info)
    del sd
    torch.cuda.empty_cache()
    return llama.fuse_projections(weights, cfg)


def variant_config(kind: str, num_layers: int | None = None) -> ModelConfig:
    """``kind``'s published config (:data:`VARIANT_JSON`) through the port's
    ``config_from_hf``, cut to ``num_layers`` (SmolLM3's cut keeps a NoPE
    layer: its third and fourth layers' flags)."""
    d = dict(VARIANT_JSON[kind])
    if num_layers is not None:
        d["num_hidden_layers"] = num_layers
        if kind == "smollm3":
            d["no_rope_layers"] = d["no_rope_layers"][4 - num_layers:4]
    return config_from_hf(d)


def build_variant(cfg: ModelConfig, dev, seed: int) -> dict:
    """``cfg``'s weights as a dense bf16 HF checkpoint (:func:`bf16_checkpoint`,
    the arch's own tensor names) loaded through the HF loader
    (``weights_from_state_dict``: phi3's fused projections split, the biases
    and LayerNorm biases mapped), then fused as the engine serves them
    (q/k/v with their biases; gate/up where unbiased)."""
    sd = bf16_checkpoint(cfg, dev, seed)
    weights = hf_loader.weights_from_state_dict(sd, cfg, device=dev)
    del sd
    torch.cuda.empty_cache()
    return llama.fuse_projections(weights, cfg)


def use_more_bits(i: int, n: int) -> bool:
    """llama.cpp's Q4_K_M rule (``llama_tensor_get_type``) for the layers
    whose ``ffn_down`` it keeps in Q6_K: the first and last eighth and every
    third layer between."""
    return i < n // 8 or i >= 7 * n // 8 or (i - n // 8) % 3 == 2


def build_mixtral(cfg: ModelConfig, dev, seed: int, down_kinds=None) -> dict:
    """Mixtral weights in the Q4_K_M recipe, drawn on the device: Q4_K
    attention (a Q8_0 ``attn_v``), fused Q4_K gate/up banks, down banks in
    Q6_K on the ``use_more_bits`` layers and Q4_K on the rest (or
    ``down_kinds[i]`` in "q6k", "q4k", "bf16"), a bf16 router of N(0, 1)/sqrt(H),
    a bf16 embedding and a Q6_K-style head: ~39 GB at 32 layers."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    h, e = cfg.hidden_size, cfg.num_experts
    mi = cfg.moe_intermediate_size or cfg.intermediate_size
    down_fns = {"q6k": lambda: q6k(h, mi, gen, dev, e=e), "q4k": lambda: q4k(h, mi, gen, dev, e=e),
                "bf16": lambda: bf16_bank(h, mi, gen, dev, e)}
    layers = []
    for i in range(cfg.num_layers):
        kind = down_kinds[i] if down_kinds else (
            "q6k" if use_more_bits(i, cfg.num_layers) else "q4k")
        layers.append({
            "attn_norm": torch.ones(h, device=dev, dtype=torch.bfloat16),
            "ffn_norm": torch.ones(h, device=dev, dtype=torch.bfloat16),
            "wq": q4k(cfg.q_dim, h, gen, dev),
            "wk": q4k(cfg.kv_dim, h, gen, dev),
            "wv": q8(cfg.kv_dim, h, gen, dev),
            "wo": q4k(h, cfg.q_dim, gen, dev),
            "router": (torch.randn((e, h), generator=gen, device=dev) / math.sqrt(h)
                       ).to(torch.bfloat16),
            "experts": {"gateup": q4k(2 * mi, h, gen, dev, e=e), "down": down_fns[kind]()},
        })
    return {
        "embed": torch.randn((cfg.vocab_size, h), generator=gen, device=dev).to(torch.bfloat16),
        "layers": layers,
        "final_norm": torch.ones(h, device=dev, dtype=torch.bfloat16),
        "lm_head": q6k(cfg.vocab_size, h, gen, dev),
    }


def q5_k_m(n_layers: int):
    """llama.cpp's Q5_K_M recipe (``llama_tensor_get_type``) as
    Qwen/Qwen2.5-7B-Instruct-GGUF's ``q5_k_m`` file applies it: Q5_K for
    the projections and the embedding, Q6_K for ``attn_v`` and ``ffn_down``
    on the ``use_more_bits`` layers (half of them) and for ``output``."""
    def type_of(stem: str, layer) -> GGMLType:
        if stem == "output" or (stem in ("attn_v", "ffn_down")
                                and use_more_bits(layer, n_layers)):
            return GGMLType.Q6_K
        return GGMLType.Q5_K
    return type_of


def q2_k_mix(stem: str, layer) -> GGMLType:
    """Qwen3-30B-A3B's Q2_K mix: Q2_K for attention q/k/o, the gate/up
    expert banks and the embedding, Q3_K for ``attn_v`` and the down banks
    (llama.cpp's Q2_K recipe keeps those a step up), a Q6_K head."""
    if stem == "output":
        return GGMLType.Q6_K
    return GGMLType.Q3_K if stem in ("attn_v", "ffn_down_exps") else GGMLType.Q2_K


def gguf_config(base: dict) -> ModelConfig:
    """The config the GGUF loader reads from a file of ``base``'s geometry
    (``config_from_gguf`` of the metadata a converter writes): no sliding
    window (GGUF stores none for Qwen2), ``attention.key_length`` for
    Qwen3's head_dim of 128."""
    return config_from_gguf(gguf_metadata(ModelConfig(**base)))


def build_gguf(cfg: ModelConfig, dev, seed: int, type_of) -> dict:
    """``cfg``'s weights as a GGUF file in the mix ``type_of`` stores them,
    read through ``load_gguf_model``: a :class:`DrawnGGUF` draws each
    tensor's raw blocks on the device as the loader reads it (a generator
    of the tensor's own seed), the loader decodes them there into planar
    QTensors (norms, biases and the router dense); then q/k/v, gate/up and
    the experts' gate/up fused where their types match. Logs the load's
    seconds and its raw and planar sizes."""
    content = DrawnGGUF(gguf_metadata(cfg), llama_family_tensors(cfg, type_of), dev, seed)
    t0 = time.monotonic()
    lcfg, weights, _ = load_gguf_model(content, device=dev)
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    check(lcfg == cfg, f"load_gguf_model read {lcfg}, not {cfg}")
    mix = collections.Counter(t.ggml_type.name for t in content.tensors.values())
    log(f"  load_gguf_model: {len(content.tensors)} tensors ({dict(mix)}), "
        f"{content.nbytes() / 2**30:.2f} GiB of raw blocks drawn and decoded on the device in "
        f"{dt:.1f} s ({torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB allocated)")
    weights = llama.fuse_projections(weights, cfg)
    torch.cuda.empty_cache()
    return weights


def build_weights(cfg: ModelConfig, dev, seed: int) -> dict:
    """Fused-projection weights of ``cfg`` (wqkv, wgateup), Q4_K layers,
    Q8_0 lm_head, bf16 embedding: ~5.2 + 0.6 + 1.05 GB at 32 layers."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    h, i = cfg.hidden_size, cfg.intermediate_size
    layers = []
    for _ in range(cfg.num_layers):
        layers.append({
            "attn_norm": torch.ones(h, device=dev, dtype=torch.bfloat16),
            "ffn_norm": torch.ones(h, device=dev, dtype=torch.bfloat16),
            "wqkv": q4k(cfg.q_dim + 2 * cfg.kv_dim, h, gen, dev),
            "wo": q4k(h, cfg.q_dim, gen, dev),
            "wgateup": q4k(2 * i, h, gen, dev),
            "down": q4k(h, i, gen, dev),
        })
    return {
        "embed": torch.randn((cfg.vocab_size, h), generator=gen, device=dev).to(torch.bfloat16),
        "layers": layers,
        "final_norm": torch.ones(h, device=dev, dtype=torch.bfloat16),
        "lm_head": q8(cfg.vocab_size, h, gen, dev),
    }


def build_gemma(cfg: ModelConfig, dev, seed: int) -> dict:
    """Gemma-2 or Gemma-3 weights of ``cfg`` in bf16, drawn on the device:
    fused projections (wqkv, wgateup) of N(0, 0.02^2), the four norms of a
    layer, Gemma-3's q/k norms and the final norm N(0, 0.1^2) (stored as w
    - 1, so applied near 1, and not ones), the tied embedding, the config's
    layer windows: ~18.5 GB for Gemma-2-9B at 42 layers, ~23.5 GB for
    Gemma-3-12B at 48."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    h, i = cfg.hidden_size, cfg.intermediate_size

    def draw(*shape, std=0.02):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16).mul_(std)

    layers = []
    for _ in range(cfg.num_layers):
        layers.append({
            **{k: draw(h, std=0.1) for k in ("attn_norm", "post_attn_norm", "ffn_norm",
                                              "post_ffn_norm")},
            "wqkv": draw(cfg.q_dim + 2 * cfg.kv_dim, h), "wo": draw(h, cfg.q_dim),
            "wgateup": draw(2 * i, h), "down": draw(h, i),
            **({k: draw(cfg.head_dim, std=0.1) for k in ("q_norm", "k_norm")}
               if cfg.qk_norm else {}),
        })
    return {"embed": draw(cfg.vocab_size, h), "layers": layers,
            "final_norm": draw(h, std=0.1), "lm_head": None}


def build_gpt_oss(cfg: ModelConfig, dev, seed: int) -> dict:
    """gpt-oss weights of ``cfg`` in bf16, drawn on the device: fused q/k/v
    (``wqkv``) and o of N(0, 0.02^2) with biases of N(0, 0.1^2), f32 sinks
    of N(0, 1), a router of N(0, 0.02^2) with a bias of N(0, 0.1^2), the
    expert banks in the port's layout (``gateup`` [E, 2I, H], ``down`` [E,
    H, I]) of N(0, 0.02^2) with biases of N(0, 0.1^2), norms of ones, an
    untied head: ~41.8 GB at 24 layers (20.9 G parameters)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    h, i, e = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts

    def draw(*shape, std=0.02, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype).mul_(std)

    layers = []
    for _ in range(cfg.num_layers):
        layers.append({
            "attn_norm": torch.ones(h, device=dev, dtype=torch.bfloat16),
            "ffn_norm": torch.ones(h, device=dev, dtype=torch.bfloat16),
            "wqkv": draw(cfg.q_dim + 2 * cfg.kv_dim, h),
            "wqkv_bias": draw(cfg.q_dim + 2 * cfg.kv_dim, std=0.1),
            "wo": draw(h, cfg.q_dim), "wo_bias": draw(h, std=0.1),
            "sinks": draw(cfg.num_heads, std=1.0, dtype=torch.float32),
            "router": draw(e, h), "router_bias": draw(e, std=0.1),
            "experts": {"gateup": draw(e, 2 * i, h), "gateup_bias": draw(e, 2 * i, std=0.1),
                        "down": draw(e, h, i), "down_bias": draw(e, h, std=0.1)},
        })
    return {"embed": draw(cfg.vocab_size, h), "layers": layers,
            "final_norm": torch.ones(h, device=dev, dtype=torch.bfloat16),
            "lm_head": draw(cfg.vocab_size, h)}


def build_qwen(cfg: ModelConfig, dev, seed: int) -> dict:
    """Qwen2.5 or Qwen3-MoE weights of ``cfg`` in bf16, drawn on the device:
    fused q/k/v (``wqkv``, with its biases of N(0, 0.1^2) for qwen2) and o
    of N(0, 0.02^2), q/k norms of 1 + N(0, 0.1^2) where the config has them,
    the dense MLP fused (``wgateup``, ``down``) or the router and the
    expert banks in the grouped kernels' layout (``gateup`` [E, 2I, H],
    ``down`` [E, H, I]) of N(0, 0.02^2), norms of ones, an untied head:
    ~15.2 GB for Qwen2.5-7B, ~61.1 GB for Qwen3-30B-A3B at 48 layers."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    h = cfg.hidden_size

    def draw(*shape, std=0.02):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16).mul_(std)

    layers = []
    for _ in range(cfg.num_layers):
        lw = {"attn_norm": torch.ones(h, device=dev, dtype=torch.bfloat16),
              "ffn_norm": torch.ones(h, device=dev, dtype=torch.bfloat16),
              "wqkv": draw(cfg.q_dim + 2 * cfg.kv_dim, h), "wo": draw(h, cfg.q_dim)}
        if cfg.arch == "qwen2":
            lw["wqkv_bias"] = draw(cfg.q_dim + 2 * cfg.kv_dim, std=0.1)
        if cfg.qk_norm:
            lw["q_norm"] = draw(cfg.head_dim, std=0.1).add_(1.0)
            lw["k_norm"] = draw(cfg.head_dim, std=0.1).add_(1.0)
        if cfg.num_experts:
            e, mi = cfg.num_experts, cfg.moe_intermediate_size
            lw["router"] = draw(e, h)
            lw["experts"] = {"gateup": draw(e, 2 * mi, h), "down": draw(e, h, mi)}
        else:
            lw["wgateup"] = draw(2 * cfg.intermediate_size, h)
            lw["down"] = draw(h, cfg.intermediate_size)
        layers.append(lw)
    return {"embed": draw(cfg.vocab_size, h), "layers": layers,
            "final_norm": torch.ones(h, device=dev, dtype=torch.bfloat16),
            "lm_head": draw(cfg.vocab_size, h)}


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def cold_copies(t, nbytes: int) -> list:
    """``t`` and enough copies of it (a QTensor's planes or a tensor) that
    cycling through them touches more than twice the L2 cache between two
    uses of one copy, as a decode step streams each weight once."""
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size", 50 << 20)
    extra = max(0, math.ceil(2 * l2 / nbytes) - 1)
    if isinstance(t, QTensor):
        return [t] + [QTensor(t.data.clone(), t.scale.clone(),
                              None if t.bias is None else t.bias.clone(),
                              group_size=t.group_size, packed=t.packed,
                              code_bits=t.code_bits) for _ in range(extra)]
    if isinstance(t, Fp8Tensor):
        return [t] + [Fp8Tensor(t.data.clone(), t.scale.clone(), t.block_shape)
                      for _ in range(extra)]
    return [t] + [t.clone() for _ in range(extra)]


def check_matmul(name, m, qt, rates, gen, dev, timed=True, out_dtype=None):
    """One W4/W8 launch (an FP8 weight: the W8 kernel's e4m3 form) against
    its plain version, timed beside its bound and ``torch.matmul`` on the
    bf16 weight unless ``timed=False``."""
    n, k = qt.shape
    mm = quant_matmul
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    got = mm(x, qt, out_dtype=out_dtype)
    ref = mm(x, qt, plain=True, out_dtype=out_dtype)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    tol = 1e-2 * ref.float().abs().max().item()
    if not (torch.isfinite(got).all() and err <= tol):
        raise AssertionError(f"{name} M={m} N={n} K={k}: max err {err} > {tol}")
    shape = f"M={m} N={n} K={k}"
    if not timed:
        log(f"  {name} {shape} bias={getattr(qt, 'bias', None) is not None} out={got.dtype}: "
            f"err {err:.3e} (tol {tol:.3e})")
        return dict(shape=shape, max_abs_err=err)
    w_bf16 = qt.dequantize(torch.float32).to(torch.bfloat16)
    copies = cold_copies(qt, qt.nbytes)
    for c in copies:  # each copy's first call (plane checks) before timing
        mm(x, c)
    weights = itertools.cycle(copies).__next__
    dense = itertools.cycle(cold_copies(w_bf16, w_bf16.numel() * 2)).__next__
    ms = time_ms(lambda: mm(x, weights()))
    dev_ms = device_ms(lambda: mm(x, weights()))
    plain_ms = time_ms(lambda: mm(x, qt, plain=True), iters=3, warmup=1)
    lib_ms = time_ms(lambda: torch.matmul(x, dense().T))
    lib_dev_ms = device_ms(lambda: torch.matmul(x, dense().T))
    del w_bf16, copies, weights, dense
    b_ms, b_by = bound(m * k * 2 + qt.nbytes + m * n * 2, 2.0 * m * n * k, rates)
    row = dict(shape=shape, max_abs_err=err, ms=ms, device_ms=dev_ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
               library_device_ms=lib_dev_ms)
    log(f"  {name} {row['shape']}: err {err:.3e} (tol {tol:.3e}) | kernel {ms:.4f} ms "
        f"(device {fmt_ms(dev_ms)}), "
        f"bound {b_ms:.4f} ms ({b_by}), plain {plain_ms:.4f} ms, torch.matmul {lib_ms:.4f} ms "
        f"(device {fmt_ms(lib_dev_ms)})")
    return row


def check_w4_edges(rows, rates, gen, dev):
    """The W4 kernel's two bodies at edge shapes (untimed): N a multiple of
    16 but not of 64, K of one step, K splits that do not divide the steps
    evenly (Mixtral's k-proj, N=1024), no bias, f32 output."""
    for n, k, bias in ((336, 512, True), (320, 128, False), (1024, 4096, True),
                       (4096, 14336, False)):
        qt = q4k(n, k, gen, dev)
        if not bias:
            qt = QTensor(qt.data, qt.scale, None, group_size=32, packed=True, code_bits=4)
        for m in (1, 16, 17, 64, 130):
            for out_dtype in (None, torch.float32):
                r = check_matmul("w4_matmul", m, qt, rates, gen, dev, timed=False,
                                 out_dtype=out_dtype)
                rows["w4_matmul"].append(r)
        del qt


def check_w8_edges(rows, rates, gen, dev):
    """The W8 kernel's two bodies at edge shapes (untimed), in its three
    byte formats (signed without bias at group 32 and 16, unsigned codes
    over all 256 values with bias, signed with bias): M of 1, 16, 17, 64 and
    130; N a multiple of 16 but not of 64; K of one step; N 1024 at K 4096
    (K splits that do not divide its steps evenly); N 4112 at K 4096 (the
    128-column blocks, the last one partly past N); bf16 and f32 output."""
    for n, k in ((336, 512), (336, 128), (1024, 4096), (4112, 4096)):
        for fmt in ("s8", "s8_gs16", "u8_bias", "s8_gs16_bias"):
            gs = 16 if "gs16" in fmt else 32
            if fmt.startswith("u8"):
                data = torch.randint(0, 256, (k, n), generator=gen, device=dev,
                                     dtype=torch.int32).to(torch.uint8)
                scale = (0.75 + 0.5 * torch.rand((k // gs, n), generator=gen, device=dev)
                         ) / math.sqrt(k * 21845.0)
                qt = QTensor(data, scale, -127.5 * scale, group_size=gs, packed=False,
                             code_bits=8)
            else:
                qt = q8(n, k, gen, dev, gs=gs)
                if fmt.endswith("bias"):
                    qt = QTensor(qt.data, qt.scale, -3.0 * qt.scale, group_size=gs,
                                 packed=False, code_bits=8)
            for m in (1, 16, 17, 64, 130):
                for out_dtype in (None, torch.float32):
                    r = check_matmul("w8_matmul", m, qt, rates, gen, dev, timed=False,
                                     out_dtype=out_dtype)
                    r["shape"] += f" {fmt}"
                    rows["w8_matmul"].append(r)
            del qt


def check_wide_edges(rows, rates, gen, dev):
    """The wide-group forms at edge shapes (untimed), on layers decoded from
    checkpoint words: W4 at group 64 (GPTQ, v2 zeros) and 128 (AWQ), W8 at
    64, 128 and per-column (g = K); N a multiple of 16 but not of 64; K of one
    step; N 1024 at K 4096, whose decode splits cut groups (W4's groups of
    128 span two steps, a per-column group every split); M of 1, 16, 17 and
    130; bf16 and f32 output."""
    cases = (("w4_matmul_wide", (336, 512), dict(bits=4, group=64, zero_offset=0)),
             ("w4_matmul_wide", (1024, 4096), dict(bits=4, group=128, awq=True)),
             ("w8_matmul_wide", (336, 512), dict(bits=8, group=64)),
             ("w8_matmul_wide", (336, 128), dict(bits=8, group=0)),
             ("w8_matmul_wide", (1024, 4096), dict(bits=8, group=128)),
             ("w8_matmul_wide", (1024, 4096), dict(bits=8, group=0)))
    for name, (n, k), kw in cases:
        qt = wide_layer(n, k, gen, dev, **kw)
        for m in (1, 16, 17, 130):
            for out_dtype in (None, torch.float32):
                r = check_matmul(name, m, qt, rates, gen, dev, timed=False, out_dtype=out_dtype)
                r["shape"] += f" group {qt.group_size}"
                rows[name].append(r)
        del qt


def grouped_routing(ntok, e, routing, gen, dev, top=2):
    """Top-``top`` choices of ``ntok`` tokens over ``e`` experts: distinct
    experts drawn from the generator ("random"), every choice on the last
    expert ("all_to_one"), or random with expert 2 left empty."""
    if top == 2:
        first = torch.randint(0, e, (ntok,), generator=gen, device=dev)
        second = (first + torch.randint(1, e, (ntok,), generator=gen, device=dev)) % e
        topi = torch.stack([first, second], dim=1)
    else:
        topi = torch.rand((ntok, e), generator=gen, device=dev).argsort(dim=1)[:, :top]
    if routing == "all_to_one":
        topi[:] = e - 1
    elif routing == "empty_expert":
        topi[topi == 2] = 3
    return topi, torch.rand((ntok, top), generator=gen, device=dev)


def check_grouped(name, w, ntok, rates, gen, dev, routing="random", timed=True, top=2,
                  out_dtype=None, route_seed=None):
    """One grouped kernel on a bank ``w`` ([E, N, K]: QTensor or bf16) for
    ``ntok`` tokens routed top-``top``, against its plain version (a
    quantized bank's output in ``out_dtype`` when given); timed with its
    bound and library yardstick when ``timed``. With ``route_seed`` the
    routing and the tokens come from a generator of that seed, so that two
    banks of one shape see the same ones."""
    dense = isinstance(w, torch.Tensor)
    e, n, k = w.shape
    if route_seed is not None:
        gen = torch.Generator(device=dev).manual_seed(route_seed)
    topi, topw = grouped_routing(ntok, e, routing, gen, dev, top)
    tm = grouped_tile(ntok * top)
    st, dest, _, tiles, n_used, mp = build_groups(topi, topw, e, tm)
    x = torch.randn((ntok, k), generator=gen, device=dev).to(torch.bfloat16)
    xs = torch.zeros((mp, k), device=dev, dtype=torch.bfloat16)
    xs[dest] = x[st]
    fn = dense_matmul_grouped if dense else quant_matmul_grouped
    kw = {} if out_dtype is None else dict(out_dtype=out_dtype)

    def run(plain=False):
        return fn(xs, w, tiles, tm=tm, n_used_tiles=n_used, plain=plain, **kw)

    got, again, ref = run(), run(), run(plain=True)
    torch.cuda.synchronize()
    used = int(n_used)
    err = (got.float() - ref.float()).abs().max().item()
    tol = 1e-2 * ref.float().abs().max().item()
    if not (torch.isfinite(got).all() and err <= tol and bool((got[used * tm:] == 0).all())
            and torch.equal(got, again)):
        raise AssertionError(f"{name} {routing} E={e} N={n} K={k} tokens={ntok}: "
                             f"max err {err} > {tol}, unused tiles not zero or two calls differ")
    shape = f"E={e} N={n} K={k} n*k={top * ntok} tm={tm} used tiles={used} ({routing})"
    if not dense and w.group_size > 32:
        shape += f" group {w.group_size}" + (f" out {got.dtype}" if out_dtype else "")
    plan_of = getattr(_moe_grouped, "dense_grouped_plan", None)  # absent in older trees
    if dense and plan_of is not None:
        plan = plan_of(tm)
        shape += f" [{plan.body} body, {plan.columns} columns]"
    if not timed:
        log(f"  {name} {shape}: err {err:.3e} (tol {tol:.3e})")
        return dict(shape=shape, max_abs_err=err)
    tl = tiles[:used].tolist()
    spans = {}  # expert → its tiles' row span (an expert's tiles are contiguous)
    for t, ex in enumerate(tl):
        a, _ = spans.get(ex, (t * tm, 0))
        spans[ex] = (a, (t + 1) * tm)
    wd = {ex: (w[ex] if dense else w.bank(ex).dequantize(torch.float32).to(torch.bfloat16))
          for ex in spans}
    ms = time_ms(run)
    dev_ms = device_ms(run)
    plain_ms = time_ms(lambda: run(plain=True), iters=3, warmup=1)
    lib_ms = time_ms(lambda: [torch.matmul(xs[a:b], wd[ex].T) for ex, (a, b) in spans.items()])
    lib_dev_ms = device_ms(lambda: [torch.matmul(xs[a:b], wd[ex].T)
                                    for ex, (a, b) in spans.items()])
    del wd
    # the function's own work: the touched experts' planes and the n*k real
    # (token, choice) rows, not the padding of the used tiles
    plane_bytes = sum(n * k * 2 if dense else w.bank(ex).nbytes for ex in spans)
    pairs = top * ntok
    b_ms, b_by = bound(plane_bytes + pairs * k * 2 + pairs * n * 2, 2.0 * pairs * n * k, rates)
    row = dict(shape=shape, max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, library_device_ms=lib_dev_ms,
               experts=len(spans))
    log(f"  {name} {shape}, {len(spans)} experts: err {err:.3e} (tol {tol:.3e}) | kernel "
        f"{ms:.4f} ms (device {fmt_ms(dev_ms)}), bound {b_ms:.4f} ms ({b_by}), plain {plain_ms:.4f} ms, "
        f"torch.matmul per group {lib_ms:.4f} ms (device {fmt_ms(lib_dev_ms)})")
    return row


def check_grouped_kernels(rows, rates, gen, dev, e=8, h=4096, mi=14336):
    """Phase 2's grouped part: Mixtral-8x7B banks at decode (8 tokens) and
    a 512-token prefill, plus the all-to-one and empty-expert routings."""
    banks = [
        ("w4_matmul_g", "gate/up, fused", lambda: q4k(2 * mi, h, gen, dev, e=e), (8, 512)),
        ("w4_matmul_g", "Q4_K down", lambda: q4k(h, mi, gen, dev, e=e), (8, 512)),
        ("w8_matmul_g", "Q6_K down", lambda: q6k(h, mi, gen, dev, e=e), (8, 512)),
        ("w8_matmul_g", "widened down", lambda: widened(h, mi, gen, dev, e), (8, 512)),
        ("dense_matmul_g", "bf16 down", lambda: bf16_bank(h, mi, gen, dev, e), (8, 512)),
    ]
    for name, what, make, sizes in banks:
        w = make()
        for ntok in sizes:
            r = check_grouped(name, w, ntok, rates, gen, dev)
            r["shape"] = f"{what}: {r['shape']}"
            rows[name].append(r)
        for routing in ("all_to_one", "empty_expert"):
            # both row tiles (16 and 64 rows) for the W4 and W8 bodies
            for ntok in ((8, 512) if name in ("w4_matmul_g", "w8_matmul_g") else (8,)):
                rows[name].append(check_grouped(name, w, ntok, rates, gen, dev, routing,
                                                timed=False))
        del w
        torch.cuda.empty_cache()


def check_wide_grouped(rows, rates, gen, dev):
    """Phase 2's wide-group grouped forms on expert banks drawn as GPTQ and
    AWQ checkpoints store them (:func:`quant_bank`): Mixtral-8x7B's AWQ
    banks at group 128 (gate/up fused [8, 28672, 4096] and down [8, 4096,
    14336], both W4, top-2) at n*k = 16 and 1024, each beside a Q4_K bank
    of its shape (group 32) on the same routing and tokens;
    Qwen1.5-MoE-A2.7B's GPTQ-Int4 banks at group 128 (W4 gate/up fused [60,
    2816, 2048], W8 down [60, 2048, 1408], unsigned codes with a bias,
    top-4) at n*k = 32 (8 decode tokens) and 2048 (a 512-token prefill),
    with the all-to-one and empty-expert routings at both row tiles; then
    untimed edges on Qwen1.5-MoE's shapes: W4 at group 64, W8 at 64 and
    per-column (g = K = 1408), each at both row tiles in those routings,
    with bf16 and f32 output; last the decode kernel at GQA group 1
    (Qwen1.5-MoE's 16/16 heads) at the table's B=8 row."""
    for what, (n, k) in (("gate/up, fused", (28672, 4096)), ("down", (4096, 14336))):
        for name, w in (("w4_matmul_wide_g", quant_bank(8, n, k, gen, dev, awq=True)),
                        ("w4_matmul_g", q4k(n, k, gen, dev, e=8))):
            for ntok in (8, 512):
                r = check_grouped(name, w, ntok, rates, gen, dev, route_seed=SEED + 40 + ntok)
                r["shape"] = (f"Mixtral {'AWQ' if w.group_size == 128 else 'Q4_K'} {what} "
                              f"(same routing): {r['shape']}")
                rows[name].append(r)
            del w
            torch.cuda.empty_cache()
    banks = [
        ("w4_matmul_wide_g", "Qwen1.5-MoE gate/up, fused", 4,
         lambda: quant_bank(60, 2816, 2048, gen, dev), (8, 512), ("all_to_one", "empty_expert")),
        ("w8_matmul_wide_g", "Qwen1.5-MoE down (u8, bias)", 4,
         lambda: quant_bank(60, 2048, 1408, gen, dev), (8, 512), ("all_to_one", "empty_expert")),
    ]
    for name, what, top, make, sizes, routings in banks:
        w = make()
        check(w.group_size == 128 and w.packed == name.startswith("w4"),
              f"{what}: group {w.group_size}, packed {w.packed}")
        for ntok in sizes:
            r = check_grouped(name, w, ntok, rates, gen, dev, top=top)
            r["shape"] = f"{what}: {r['shape']}"
            rows[name].append(r)
        for routing in routings:
            for ntok in sizes:
                rows[name].append(check_grouped(name, w, ntok, rates, gen, dev, routing,
                                                timed=False, top=top))
        del w
        torch.cuda.empty_cache()
    # (kernel, (N, K), bits, group): GPTQ 4-bit at 64 packs (K/2 = 1024); 8-bit
    # at 64 and 4-bit per-column keep a byte a code
    edges = [("w4_matmul_wide_g", (2816, 2048), 4, 64), ("w8_matmul_wide_g", (2048, 1408), 8, 64),
             ("w8_matmul_wide_g", (2048, 1408), 4, 0)]
    for name, (n, k), bits, group in edges:
        w = quant_bank(60, n, k, gen, dev, bits=bits, group=group)
        check(w.packed == name.startswith("w4"), f"{name} group {group}: packed {w.packed}")
        for routing, ntok, out_dtype in (("random", 8, torch.float32), ("all_to_one", 8, None),
                                         ("empty_expert", 8, None), ("random", 512, None),
                                         ("all_to_one", 512, torch.float32),
                                         ("empty_expert", 512, None)):
            rows[name].append(check_grouped(name, w, ntok, rates, gen, dev, routing, timed=False,
                                            top=4, out_dtype=out_dtype))
        del w
        torch.cuda.empty_cache()
    rows["paged_decode"].append(check_decode(rates, gen, dev, n_q=16, n_kv=16, timed=False))


def gguf_layer(t: str, shape, gen, dev, bias: bool = True) -> QTensor:
    """A matrix or bank of GGML type ``t`` drawn as raw GGUF blocks on the
    device (``gguf/drawn.py``: weights centred on zero, rms 1/sqrt(K)) and
    decoded there by the port's planarizers, as the GGUF loader decodes a
    file's tensor; ``bias=False`` drops the bias plane."""
    qt = QTensor.from_gguf_raw(draw_blocks(GGMLType[t], shape, gen, dev), GGMLType[t],
                               tuple(shape), device=dev)
    if not bias:
        qt = QTensor(qt.data, qt.scale, None, group_size=qt.group_size, packed=qt.packed,
                     code_bits=qt.code_bits)
    return qt


def check_gguf_kernels(rows, rates, gen, dev):
    """Phase 2's GGUF forms on layers drawn as raw blocks and decoded by the
    port's planarizers (:func:`gguf_layer`): W4 at group 16 (Q2_K) at
    Qwen3-30B-A3B's ``attn_q`` (N 4096, K 2048) and ``attn_output`` (N 2048,
    K 4096), M 8 and 512, and over its fused gate/up bank (E 128, N 1536, K
    2048, top-8) at n*k = 48 and 2048; then untimed: the W4 rows' edge
    shapes (M 1, 16, 17, 64 and 130, N a multiple of 16 but not of 64, K of
    one step, K splits that do not divide the steps, no bias, f32 output)
    and the all-to-one and empty-expert routings at both row tiles. W8 with
    unsigned codes and a bias at group 32 (Q5_K) at Qwen2.5-7B's gate-up (M
    8, N 37888, K 3584) and down (M 8 and 512, N 3584, K 18944); Q3_K banks
    (signed, group 16) at Qwen3-30B-A3B's down (E 128, N 2048, K 768) at
    n*k = 48 and 2048; Q4_0, Q4_1, Q5_0 and Q5_1 untimed at one shape."""
    for n, k in ((4096, 2048), (2048, 4096)):
        qt = gguf_layer("Q2_K", (n, k), gen, dev)
        check(qt.packed and qt.group_size == 16, f"Q2_K [{n}, {k}]: not W4 at group 16")
        for m in (8, 512):
            r = check_matmul("w4_matmul_g16", m, qt, rates, gen, dev)
            r["shape"] += " Q2_K"
            rows["w4_matmul_g16"].append(r)
        del qt
    for n, k, bias in ((336, 512, True), (1024, 4096, True), (4096, 14336, False)):
        qt = gguf_layer("Q2_K", (n, k), gen, dev, bias=bias)
        for m in (1, 16, 17, 64, 130):
            for out_dtype in (None, torch.float32):
                rows["w4_matmul_g16"].append(check_matmul("w4_matmul_g16", m, qt, rates, gen, dev,
                                                          timed=False, out_dtype=out_dtype))
        del qt
    # K of one step (128) is not whole Q2_K super-blocks: 2-bit codes in
    # nibbles and planes drawn directly
    data = torch.randint(0, 256, (64, 320), generator=gen, device=dev, dtype=torch.uint8) & 0x33
    scale = (0.75 + 0.5 * torch.rand((8, 320), generator=gen, device=dev)) / math.sqrt(1.25 * 128)
    for bias in (-1.5 * scale, None):
        qt = QTensor(data, scale, bias, group_size=16, packed=True, code_bits=2)
        for m in (1, 17):
            rows["w4_matmul_g16"].append(check_matmul("w4_matmul_g16", m, qt, rates, gen, dev,
                                                      timed=False))
    bank = gguf_layer("Q2_K", (128, 1536, 2048), gen, dev)
    for ntok in (6, 256):
        r = check_grouped("w4_matmul_g16_g", bank, ntok, rates, gen, dev, top=8)
        r["shape"] = f"Qwen3-30B-A3B Q2_K gate/up, fused: {r['shape']}"
        rows["w4_matmul_g16_g"].append(r)
    for routing in ("all_to_one", "empty_expert"):
        for ntok in (6, 256):
            for out_dtype in (None, torch.float32):
                rows["w4_matmul_g16_g"].append(check_grouped(
                    "w4_matmul_g16_g", bank, ntok, rates, gen, dev, routing, timed=False, top=8,
                    out_dtype=out_dtype))
    nob = QTensor(bank.data, bank.scale, None, group_size=16, packed=True, code_bits=2)
    rows["w4_matmul_g16_g"].append(check_grouped("w4_matmul_g16_g", nob, 6, rates, gen, dev,
                                                 timed=False, top=8))
    rows["w4_matmul_g16_g"].append(check_grouped("w4_matmul_g16_g", nob, 256, rates, gen, dev,
                                                 timed=False, top=8))
    del bank, nob
    torch.cuda.empty_cache()
    for n, k, ms in ((37888, 3584, (8,)), (3584, 18944, (8, 512))):
        qt = gguf_layer("Q5_K", (n, k), gen, dev)
        check(not qt.packed and qt.group_size == 32 and qt.bias is not None,
              f"Q5_K [{n}, {k}]: not W8 unsigned with a bias at group 32")
        for m in ms:
            r = check_matmul("w8_matmul", m, qt, rates, gen, dev)
            r["shape"] += " Q5_K (u8, bias)"
            rows["w8_matmul"].append(r)
        del qt
    down = gguf_layer("Q3_K", (128, 2048, 768), gen, dev)
    check(down.signed and down.group_size == 16 and down.bias is None, "Q3_K bank: not S8 g16")
    for ntok in (6, 256):
        r = check_grouped("w8_matmul_g", down, ntok, rates, gen, dev, top=8)
        r["shape"] = f"Qwen3-30B-A3B Q3_K down: {r['shape']}"
        rows["w8_matmul_g"].append(r)
    del down
    for t in ("Q4_0", "Q4_1", "Q5_0", "Q5_1"):
        qt = gguf_layer(t, (4096, 4096), gen, dev)
        name = "w4_matmul" if qt.packed else "w8_matmul"
        for m in (8, 130):
            r = check_matmul(name, m, qt, rates, gen, dev, timed=False)
            r["shape"] += f" {t}"
            rows[name].append(r)
        del qt
    torch.cuda.empty_cache()


def check_expert_banks(rows, rates, gen, dev, model: str, e: int, h: int, mi: int, top: int,
                       tokens, edges: bool = False):
    """Phase 2's dense grouped kernel on ``model``'s bf16 expert banks
    (gate/up [e, 2 mi, h], down [e, h, mi]), top-``top``, at each token
    count of ``tokens``; ``edges`` adds an untimed routing of 6 tokens with
    an empty expert."""
    for what, make in ((f"{model} gate/up", lambda: bf16_bank(2 * mi, h, gen, dev, e)),
                       (f"{model} down", lambda: bf16_bank(h, mi, gen, dev, e))):
        w = make()
        for ntok in tokens:
            r = check_grouped("dense_matmul_g", w, ntok, rates, gen, dev, top=top)
            r["shape"] = f"{what}: {r['shape']}"
            rows["dense_matmul_g"].append(r)
        if edges:
            rows["dense_matmul_g"].append(check_grouped(
                "dense_matmul_g", w, 6, rates, gen, dev, "empty_expert", timed=False, top=top))
        del w
        torch.cuda.empty_cache()


def sdpa_timed(q, k, v, mask):
    """Time ``scaled_dot_product_attention`` on the first backend that takes
    these inputs → (ms, device ms, backend name)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        def run(backend=backend):
            with sdpa_kernel([backend]):
                return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        try:
            run()
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        return time_ms(run), device_ms(run), backend.name
    raise AssertionError("no SDPA backend takes these inputs")


def check_mla(rates, gen, dev, bs, kv_lens=(1, 2048, 700, 0, 65, 1333, 64, 1024),
              positions=2048):
    """The MLA decode kernel at DeepSeek-V2-Lite's decode shapes against its
    plain version (module docstring), on tables of ``positions`` positions
    in blocks of ``bs``; two calls bit-equal. Rows 2 and 3 drop their writes
    where there are 8 rows; with fewer, none does."""
    b, nh, rank, d, n_layers = len(kv_lens), 16, 512, 576, 2
    kv_lens = torch.tensor(kv_lens, device=dev, dtype=torch.int32)
    w = positions // bs
    bt, s_total = paged_layout(b, bs, w, gen, dev)
    pool = torch.randn((n_layers, s_total, d), generator=gen, device=dev).to(torch.bfloat16)
    q = torch.randn((b, nh, d), generator=gen, device=dev).to(torch.bfloat16)
    rows_new = torch.randn((b, d), generator=gen, device=dev).to(torch.bfloat16)
    slots = slots_for(bt, (kv_lens - 1).clamp_min(0)[:, None], bs)[:, 0].contiguous()
    full = bool((kv_lens == positions).all())
    if b == 8 and not full:
        slots[2] = -1  # a dropped write
        slots[3] = -1  # the kv_len 0 row: a padding row of the engine's batch
        # row 1 (kv_len 2048) writes into the last block of its table
        check(int(slots[1]) // bs == int(bt[1, -1]), "mla: row 1 must write its last block")
    scale = 192 ** -0.5  # qk_head_dim ** -0.5
    p1, p2 = pool.clone(), pool.clone()
    args = (rows_new, slots, bt, kv_lens, 1)
    kw = dict(rank=rank, block_size=bs, scale=scale)
    got = mla_decode(q, p1, *args, **kw)
    again = mla_decode(q, p1, *args, **kw)
    ref = mla_decode(q, p2, *args, **kw, plain=True)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    # two rows drop their writes into the trash row (the last), from two
    # blocks at once: what it holds after is not defined and never read
    pool_ok = bool((p1[1, :-1] == p2[1, :-1]).all()) and bool((p1[0] == pool[0]).all())
    zero_ok = bool((got[kv_lens == 0] == 0).all())
    if not (torch.isfinite(got).all() and err <= 2e-2 and pool_ok and zero_ok
            and torch.equal(got, again)):
        raise AssertionError(f"mla_decode bs={bs}: max err {err}, pool written right "
                             f"{pool_ok}, kv_len-0 rows zero {zero_ok}, two calls equal "
                             f"{torch.equal(got, again)}")
    del ref, again
    keys = p1[1][(bt.long()[:, :, None] * bs + torch.arange(bs, device=dev)).reshape(b, -1)]
    kk = keys[:, None].expand(b, nh, keys.shape[1], d).contiguous()
    vv = kk[..., :rank]
    mask = None if full else (torch.arange(keys.shape[1], device=dev)[None]
                              < kv_lens[:, None])[:, None, None]
    ms = time_ms(lambda: mla_decode(q, p1, *args, **kw))
    dev_ms = device_ms(lambda: mla_decode(q, p1, *args, **kw))
    plain_ms = time_ms(lambda: mla_decode(q, p2, *args, **kw, plain=True), iters=3, warmup=1)
    lib_ms, lib_dev_ms, backend = sdpa_timed(q[:, :, None], kk, vv, mask)
    del kk, vv, keys
    tokens = int(kv_lens.sum())
    # each visible row read once, q and the new rows read, the rows written, out written
    nbytes = tokens * d * 2 + b * nh * d * 2 + 2 * b * d * 2 + b * nh * rank * 2
    b_ms, b_by = bound(nbytes, 2.0 * tokens * nh * (d + rank), rates)
    lens = f"kv_lens={positions} x {b}" if full else f"kv_lens 0..{positions}"
    row = dict(shape=f"B={b} nh={nh} D={d} rank={rank} bs={bs} {lens}",
               max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=lib_ms, library_device_ms=lib_dev_ms,
               library=f"sdpa ({backend})")
    log(f"  mla_decode {row['shape']}: err {err:.3e} (tol 2e-2), pool exact, two calls equal "
        f"| kernel {ms:.4f} ms (device {fmt_ms(dev_ms)}), bound {b_ms:.4f} ms ({b_by}), plain "
        f"{plain_ms:.4f} ms, sdpa [{backend}] {lib_ms:.4f} ms (device {fmt_ms(lib_dev_ms)})")
    return row


def paged_layout(b, bs, w, gen, dev):
    """Random block tables for `b` rows of `w` blocks, pools of b*w+1 blocks."""
    bt = torch.randperm(b * w, generator=gen, device=dev).to(torch.int32).reshape(b, w)
    return bt, (b * w + 1) * bs


def slots_for(bt, pos, bs):
    """Physical slots of positions pos [B, T] (long) through tables bt."""
    return (bt.gather(1, (pos // bs).long()) * bs + pos % bs).to(torch.int32)


def kv_pools(gen, n_kv, s_total, hd, kv_quant, dev):
    """K and V pools [n_kv, S, hd] of random rows: bf16, or with
    ``kv_quant`` their 1-byte codes, each with its bf16 scale plane [n_kv,
    S] → (k, k_scale, v, v_scale), the scales None for bf16."""
    out = []
    for _ in range(2):
        rows = torch.randn((n_kv, s_total, hd), generator=gen, device=dev).to(torch.bfloat16)
        if kv_quant is None:
            out += [rows, None]
        else:
            codes, s = quantize_rows(rows, CODE_DTYPES[kv_quant])
            out += [codes, s.to(torch.bfloat16)]
    return out


def pools_equal(a, b) -> bool:
    """Two (k, k_scale, v, v_scale) pool sets bit-equal, as bytes, but at the
    trash slot (the last), where the plain versions park dropped writes."""
    return all(x is None or torch.equal(x[:, :-1].contiguous().view(torch.uint8),
                                        y[:, :-1].contiguous().view(torch.uint8))
               for x, y in zip(a, b))


CAP_Q = 8.0  # q's scale with a softcap: scores of std ~8, so a cap of 50 moves the top ones
CAP_CONTROL = 0.1  # the least that an option must move the plain version's output (5x the tol)
SINK_MEAN = 6.0  # sinks of N(6, 1): e^6 ~ 400 positions' worth of softmax mass at scores N(0, 1)


def check_cap_bites(name, capped, uncapped, what: str = "softcap") -> float:
    """The control of a softcapped (or sinks) row: the plain version with
    the option and without it (f32 values of the rows compared) differ by
    more than ``CAP_CONTROL``, so a kernel that dropped the tanh (or the
    sink) could not pass within 2e-2."""
    moved = (capped - uncapped).abs().max().item()
    if not moved > CAP_CONTROL:
        raise AssertionError(f"{name}: the {what} moves the plain version by {moved} only "
                             f"(needs > {CAP_CONTROL})")
    return moved


def draw_sinks(gen, n_q, dev):
    """Per-head f32 sinks of N(``SINK_MEAN``, 1), on the device."""
    return torch.randn(n_q, generator=gen, device=dev).add_(SINK_MEAN)


def attn_name(kernel, kv_quant, hd) -> str:
    return kernel + (f"_{kv_quant}" if kv_quant else "") + (f"_hd{hd}" if hd != 128 else "")


def quant_names(names, kv_quant) -> tuple:
    """The launch-count names of the paged kernels of ``names`` in their
    ``kv_quant`` forms (``paged_decode_hd256`` → ``paged_decode_int8_hd256``);
    the other kernels' as they are."""
    if kv_quant is None:
        return tuple(names)
    out = []
    for n in names:
        if n.startswith("paged_"):
            base, _, hd = n.partition("_hd")
            n = f"{base}_{kv_quant}" + (f"_hd{hd}" if hd else "")
        out.append(n)
    return tuple(out)


def gathered(pools, bt, bs, group):
    """Per-sequence K/V [B, n_q, P, hd] gathered (dequantized to bf16) ahead
    of time, for SDPA."""
    kk, vv = gather_kv(pools[0], pools[2], bt, bs, k_scale=pools[1], v_scale=pools[3])
    return (x.permute(0, 2, 1, 3).repeat_interleave(group, dim=1) for x in (kk, vv))


def check_decode(rates, gen, dev, kv_lens=(1024, 1, 700, 64, 65, 333, 901, 512), w=16,
                 dropped=3, kv_quant=None, n_q=32, n_kv=8, hd=128, window=0, softcap=0.0,
                 sinks=False, window_control=False, timed=True):
    """The decode kernel (its quantized form with ``kv_quant``, its
    head_dim-256 form with ``hd=256``) on tables of ``w`` blocks of 64 for
    rows of ``kv_lens`` (row ``dropped`` drops its write), with a sliding
    ``window`` and a ``softcap`` when given, against the plain version:
    within 2e-2, the pools (codes and scales) bit-equal but at the trash
    slot, two calls bit-equal; timed with its bound (bytes: the visible K/V,
    or codes and bf16 scales, read once, q read, out written, the step's
    rows read and written; a window's row sees min(kv_len, window)
    positions) and SDPA on the K/V gathered (and dequantized) ahead of time,
    the window as a boolean mask (SDPA has no softcap: that row's yardstick
    computes less). With a softcap q is ``CAP_Q`` times larger, and the
    plain version without the cap must differ from it by more than
    ``CAP_CONTROL``; with ``sinks`` (f32 per head, ``draw_sinks``) the
    plain version without them must too (SDPA has no sinks), and with
    ``window_control`` the plain version without the window. Untimed
    (``timed=False``): the checks alone."""
    b, bs = len(kv_lens), 64
    kv_lens = torch.tensor(kv_lens, device=dev, dtype=torch.int32)
    bt, s_total = paged_layout(b, bs, w, gen, dev)
    pools = kv_pools(gen, n_kv, s_total, hd, kv_quant, dev)
    q = torch.randn((b, n_q, hd), generator=gen, device=dev).to(torch.bfloat16)
    if softcap:
        q *= CAP_Q  # exact in bf16
    kn = torch.randn((b, n_kv, hd), generator=gen, device=dev).to(torch.bfloat16)
    vn = torch.randn((b, n_kv, hd), generator=gen, device=dev).to(torch.bfloat16)
    slots = slots_for(bt, (kv_lens - 1)[:, None], bs)[:, 0].contiguous()
    slots[dropped] = -1  # a dropped write
    sk = draw_sinks(gen, n_q, dev) if sinks else None
    mine, ref_p = ([t if t is None else t.clone() for t in pools] for _ in range(2))
    args = (kn, vn, slots, bt, kv_lens)

    def run(p, plain=False, cap=softcap, sink=sk, win=window):
        return paged_decode_attention_fused(q, p[0], p[2], *args, block_size=bs, k_scale=p[1],
                                            v_scale=p[3], window=win, softcap=cap,
                                            sinks=sink, plain=plain)

    got, again, ref = run(mine), run(mine), run(ref_p, plain=True)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    pools_ok = pools_equal(mine, ref_p)
    name = attn_name("paged_decode", kv_quant, hd)
    if not (torch.isfinite(got).all() and err <= 2e-2 and pools_ok and torch.equal(got, again)):
        raise AssertionError(f"{name}: max err {err}, pools equal {pools_ok}, two calls equal "
                             f"{torch.equal(got, again)}")
    if softcap:
        ctl_p = [t if t is None else t.clone() for t in pools]
        moved = check_cap_bites(name, ref.float(), run(ctl_p, plain=True, cap=0.0).float())
        del ctl_p
    if sinks:
        ctl_p = [t if t is None else t.clone() for t in pools]
        sink_moved = check_cap_bites(name, ref.float(),
                                     run(ctl_p, plain=True, sink=None).float(), "sinks")
        del ctl_p
    if window_control:
        ctl_p = [t if t is None else t.clone() for t in pools]
        win_moved = check_cap_bites(name, ref.float(), run(ctl_p, plain=True, win=0).float(),
                                    "window")
        del ctl_p
    del ref
    opts = (f" window={window}" if window else "") + (
        f" softcap={softcap:g} q x{CAP_Q:g}" if softcap else "") + (" sinks" if sinks else "")
    controls = ((f", the cap moves the plain version {moved:.3e} (> {CAP_CONTROL})"
                 if softcap else "")
                + (f", the sinks move the plain version {sink_moved:.3e} (> {CAP_CONTROL})"
                   if sinks else "")
                + (f", the window moves the plain version {win_moved:.3e} (> {CAP_CONTROL})"
                   if window_control else ""))
    if not timed:
        shape = (f"B={b} n_q={n_q} n_kv={n_kv} hd={hd} bs={bs} kv_lens<={int(kv_lens.max())}"
                 + opts)
        log(f"  {name} {shape}: err {err:.3e} (tol 2e-2), pools exact but the trash slot, "
            f"two calls equal{controls}")
        return dict(shape=shape, max_abs_err=err)
    # yardstick: SDPA over K/V gathered and expanded to all query heads ahead
    # of time; no mask where every position of the table is visible
    kk, vv = gathered(mine, bt, bs, n_q // n_kv)
    ppos = torch.arange(kk.shape[2], device=dev)[None]
    visible = ppos < kv_lens[:, None]
    if window:
        visible &= kv_lens[:, None] - 1 - ppos < window
    full = bool(visible.all())
    mask = None if full else visible[:, None, None]
    q4 = q[:, :, None]
    ms = time_ms(lambda: run(mine))
    dev_ms = device_ms(lambda: run(mine))
    plain_ms = time_ms(lambda: run(ref_p, plain=True), iters=3, warmup=1)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(q4, kk, vv, attn_mask=mask)  # noqa: E731
    lib_ms, lib_dev_ms = time_ms(sdpa), device_ms(sdpa)
    del kk, vv
    tokens = int((kv_lens.clamp_max(window) if window else kv_lens).sum())  # visible positions
    row_b = hd + 2 if kv_quant else 2 * hd  # a cached row: codes and a bf16 scale, or bf16
    nbytes = (2 * tokens * n_kv * row_b + 2 * b * n_q * hd * 2 + 2 * b * n_kv * hd * 2
              + 2 * b * n_kv * row_b)
    b_ms, b_by = bound(nbytes, 4.0 * tokens * n_q * hd, rates)
    same = bool((kv_lens == kv_lens[0]).all())
    lens = (f"kv_lens={int(kv_lens[0])} x {b}" if same
            else f"kv_lens<={int(kv_lens.max())}")
    row = dict(shape=(f"{kv_quant} " if kv_quant else "")
               + f"B={b} n_q={n_q} n_kv={n_kv} hd={hd} bs={bs} {lens}{opts}",
               max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=lib_ms, library_device_ms=lib_dev_ms)
    if softcap:
        row["cap_moves_plain"] = moved
    if sinks:
        row["sinks_move_plain"] = sink_moved
    if window_control:
        row["window_moves_plain"] = win_moved
    log(f"  {name} {row['shape']}: err {err:.3e} (tol 2e-2), pools exact but the trash slot, "
        f"two calls equal{controls}"
        + f" | kernel {ms:.4f} ms (device {fmt_ms(dev_ms)}), bound {b_ms:.4f} ms "
        f"({b_by}), plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms (device "
        f"{fmt_ms(lib_dev_ms)})")
    return row


def check_prefill(rates, gen, dev, b=2, t=128, n_valid=(128, 70), past=(300, 300), n_q=32,
                  n_kv=8, bs=64, timed=True, kv_quant=None, hd=128, window=0, softcap=0.0,
                  sinks=False, window_control=False):
    """The prefill kernel (its quantized form with ``kv_quant``, its
    head_dim-256 form with ``hd=256``) on a chunk of ``t`` tokens per row on
    top of ``past`` cached positions, ``n_valid`` of them real (the rest
    dropped writes), with a sliding ``window`` and a ``softcap`` when given:
    valid rows within 2e-2 of the plain version, the pools (codes and
    scales) bit-equal to the plain version's but the trash slot (where the
    plain version parks dropped writes), a second call on the pools as they
    were bit-equal; timed with its bound and SDPA (the window as a boolean
    mask, no softcap) when ``timed``. With a softcap q is ``CAP_Q`` times
    larger, and the plain version without the cap must differ from it on
    the valid rows by more than ``CAP_CONTROL``; so must the plain version
    without ``sinks`` (``draw_sinks``), where the row has them, and the
    plain version without the window, with ``window_control``."""
    n_valid = torch.tensor(n_valid, device=dev, dtype=torch.int32)
    kv_lens = n_valid + torch.tensor(past, device=dev, dtype=torch.int32)
    w = -(-(max(past) + t) // bs)
    bt, s_total = paged_layout(b, bs, w, gen, dev)
    pools = kv_pools(gen, n_kv, s_total, hd, kv_quant, dev)
    q = torch.randn((b, t, n_q, hd), generator=gen, device=dev).to(torch.bfloat16)
    if softcap:
        q *= CAP_Q  # exact in bf16
    kn = torch.randn((b, t, n_kv, hd), generator=gen, device=dev).to(torch.bfloat16)
    vn = torch.randn((b, t, n_kv, hd), generator=gen, device=dev).to(torch.bfloat16)
    tok = torch.arange(t, device=dev)[None]
    pos = (kv_lens - n_valid)[:, None] + tok
    slots = slots_for(bt, pos.clamp_max(w * bs - 1), bs)
    slots[tok.expand(b, t) >= n_valid[:, None]] = -1
    args = (kn, vn, slots, bt, kv_lens, n_valid)
    sk = draw_sinks(gen, n_q, dev) if sinks else None

    def run(p, plain=False, cap=softcap, sink=sk, win=window):
        return paged_prefill_attention_fused(q, p[0], p[2], *args, block_size=bs, k_scale=p[1],
                                             v_scale=p[3], window=win, softcap=cap,
                                             sinks=sink, plain=plain)

    mine, again_p, ref_p = ([x if x is None else x.clone() for x in pools] for _ in range(3))
    got, again, ref = run(mine), run(again_p), run(ref_p, plain=True)
    torch.cuda.synchronize()
    valid = torch.arange(t, device=dev)[None] < n_valid[:, None]  # [B, T]
    err = (got.float() - ref.float())[valid].abs().max().item() if bool(valid.any()) else 0.0
    pools_ok = pools_equal(mine, ref_p)
    shape = ((f"{kv_quant} " if kv_quant else "")
             + f"B={b} T={t} n_valid={tuple(n_valid.tolist())} past={tuple(past)} n_q={n_q} "
             f"n_kv={n_kv} hd={hd} bs={bs}"
             + (f" window={window}" if window else "")
             + (f" softcap={softcap:g} q x{CAP_Q:g}" if softcap else "")
             + (" sinks" if sinks else ""))
    name = attn_name("paged_prefill", kv_quant, hd)
    if not (torch.isfinite(got).all() and err <= 2e-2 and pools_ok and torch.equal(got, again)):
        raise AssertionError(f"{name} {shape}: max err {err}, pools equal {pools_ok}, two "
                             f"calls equal {torch.equal(got, again)}")
    cap_note = ""
    if softcap:
        uncapped = run([x if x is None else x.clone() for x in pools], plain=True, cap=0.0)
        moved = check_cap_bites(name, ref.float()[valid], uncapped.float()[valid])
        cap_note = f", the cap moves the plain version {moved:.3e} (> {CAP_CONTROL})"
        del uncapped
    if sinks:
        sinkless = run([x if x is None else x.clone() for x in pools], plain=True, sink=None)
        sink_moved = check_cap_bites(name, ref.float()[valid], sinkless.float()[valid], "sinks")
        cap_note += f", the sinks move the plain version {sink_moved:.3e} (> {CAP_CONTROL})"
        del sinkless
    if window_control:
        unwindowed = run([x if x is None else x.clone() for x in pools], plain=True, win=0)
        win_moved = check_cap_bites(name, ref.float()[valid], unwindowed.float()[valid],
                                    "window")
        cap_note += f", the window moves the plain version {win_moved:.3e} (> {CAP_CONTROL})"
        del unwindowed
    del ref, again_p
    if not timed:
        log(f"  {name} {shape}: err {err:.3e} (tol 2e-2), pools exact, two calls equal{cap_note}")
        return dict(shape=shape, max_abs_err=err)
    kk, vv = gathered(mine, bt, bs, n_q // n_kv)
    ppos = torch.arange(kk.shape[2], device=dev)
    lim = (kv_lens - n_valid)[:, None] + tok  # [B, T]
    mask = ppos[None, None] <= lim[:, :, None]
    if window:
        mask &= lim[:, :, None] - ppos[None, None] < window
    mask = mask[:, None]  # [B, 1, T, P]
    qt_ = q.transpose(1, 2)
    ms = time_ms(lambda: run(mine))
    dev_ms = device_ms(lambda: run(mine))
    plain_ms = time_ms(lambda: run(ref_p, plain=True), iters=3, warmup=1)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(qt_, kk, vv, attn_mask=mask)  # noqa: E731
    lib_ms, lib_dev_ms = time_ms(sdpa), device_ms(sdpa)
    del kk, vv
    ctx = (kv_lens - n_valid).tolist()
    nv = n_valid.tolist()
    row_b = hd + 2 if kv_quant else 2 * hd  # a cached row: codes and a bf16 scale, or bf16
    # bytes: the past a valid token sees read once (with a window, the last
    # window - 1 positions of it), the chunk's bf16 rows read and written as
    # cached rows, q in, out
    seen = (lambda n: min(n, window)) if window else (lambda n: n)  # noqa: E731
    nbytes = sum(2 * (seen(c + 1) - 1 if v else 0) * n_kv * row_b
                 + 2 * v * n_kv * (2 * hd + row_b) + 2 * v * n_q * hd * 2
                 for c, v in zip(ctx, nv))
    # ops: causal QK and PV over the positions each valid token sees
    flops = sum(4 * n_q * hd * sum(seen(c + i + 1) for i in range(v)) for c, v in zip(ctx, nv))
    b_ms, b_by = bound(nbytes, flops, rates)
    row = dict(shape=shape, max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, library_device_ms=lib_dev_ms)
    if softcap:
        row["cap_moves_plain"] = moved
    if sinks:
        row["sinks_move_plain"] = sink_moved
    if window_control:
        row["window_moves_plain"] = win_moved
    log(f"  {name} {shape}: err {err:.3e} (tol 2e-2), pools exact, two calls equal{cap_note} | "
        f"kernel {ms:.4f} ms (device {fmt_ms(dev_ms)}), bound {b_ms:.4f} ms ({b_by}), plain "
        f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms (device {fmt_ms(lib_dev_ms)})")
    return row


def check_prefill_edges(rows, rates, gen, dev):
    """The prefill kernel at edge cases (untimed): GQA groups 1, 2 and 8,
    blocks of 16, a row with n_valid 0, pasts not a multiple of 64."""
    for n_q, n_kv, bs in ((8, 8, 64), (16, 8, 16), (64, 8, 64), (32, 8, 16)):
        rows["paged_prefill"].append(check_prefill(
            rates, gen, dev, b=3, t=150, n_valid=(150, 0, 77), past=(200, 37, 0), n_q=n_q,
            n_kv=n_kv, bs=bs, timed=False))


def check_hd80_96(rows, rates, gen, dev):
    """The paged kernels' head_dim-96 and -80 forms at Phi-3-mini's and
    Phi-2's attention (32/32 heads). Timed, head_dim 96: decode at B=8 with
    kv_lens <= 1024 and at 8 x 4096 with the 2047 window, prefill at B=2
    T=128 on 300 past and 512 tokens on 2048 past through the window;
    head_dim 80: decode at B=8 and at B=1 with 2048 positions, prefill at
    B=2 T=128 on 300 past and 512 on 512; the int8 and fp8 forms at the B=8
    and B=2 rows. Untimed, at each head dim: decode and prefill with a
    softcap and with sinks (each with its control: the plain version
    without the option differs by more than ``CAP_CONTROL``) and at GQA
    group 8 (32/4 heads)."""
    for hd in (96, 80):
        attn = dict(n_q=32, n_kv=32, hd=hd)
        d, p = rows[f"paged_decode_hd{hd}"], rows[f"paged_prefill_hd{hd}"]
        d.append(check_decode(rates, gen, dev, **attn))
        p.append(check_prefill(rates, gen, dev, **attn))
        if hd == 96:
            d.append(check_decode(rates, gen, dev, kv_lens=(4096,) * 8, w=64, dropped=7,
                                  window=2047, **attn))
            p.append(check_prefill(rates, gen, dev, b=1, t=512, n_valid=(512,), past=(2048,),
                                   window=2047, **attn))
        else:
            d.append(check_decode(rates, gen, dev, kv_lens=(2048,), w=32, dropped=0, **attn))
            p.append(check_prefill(rates, gen, dev, b=1, t=512, n_valid=(512,), past=(512,),
                                   **attn))
        for kvq in ("int8", "fp8"):
            rows[f"paged_decode_{kvq}_hd{hd}"].append(
                check_decode(rates, gen, dev, kv_quant=kvq, **attn))
            rows[f"paged_prefill_{kvq}_hd{hd}"].append(
                check_prefill(rates, gen, dev, kv_quant=kvq, **attn))
        for opt in (dict(softcap=50.0), dict(sinks=True), dict(n_q=32, n_kv=4)):
            kw = dict(attn, **opt)
            d.append(check_decode(rates, gen, dev, timed=False, **kw))
            p.append(check_prefill(rates, gen, dev, timed=False, **kw))


# ---------------------------------------------------------------------------
# phase 3: the model through the kernels and through the plain versions
# ---------------------------------------------------------------------------


def check_model(dev) -> dict:
    """Phase 3: 2 Llama-3-8B layers at full width through the kernels and
    the plain versions, over bf16 pools, then int8 and fp8 pools (the same
    weights); returns the kernel runs' launch counts by ``kv_quant``."""
    cfg = ModelConfig(**dict(LLAMA3_8B, num_layers=2))
    weights = build_weights(cfg, dev, SEED + 1)
    counts = {kvq: check_model_pools(cfg, weights, dev, kvq) for kvq in (None, "int8", "fp8")}
    del weights
    return counts


def check_model_pools(cfg, weights, dev, kv_quant) -> dict:
    bs, b, t, n_dec = 64, 2, 96, 4
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    ids = torch.randint(0, cfg.vocab_size, (b, t + n_dec), generator=gen, device=dev)
    bt = torch.arange(b * 4, device=dev, dtype=torch.int32).reshape(b, 4)
    worst = 0.0
    runs = []
    counts: dict = {}
    for plain in (False, True):
        cache = PagedKVCache.create(cfg, b * 4, bs, kv_quant=kv_quant, device=dev)
        _cuda.reset_counts()
        pos = torch.arange(t, device=dev)[None].expand(b, t)
        logits, _ = forward_paged(weights, cfg, ids[:, :t], pos, cache, bt,
                                  slots_for(bt, pos, bs), torch.full((b,), t, device=dev),
                                  block_size=bs, plain=plain)
        outs = [logits]
        for d in range(n_dec):
            p = torch.full((b, 1), t + d, device=dev)
            logits, _ = forward_paged(weights, cfg, ids[:, t + d:t + d + 1], p, cache, bt,
                                      slots_for(bt, p, bs), torch.full((b,), t + d + 1, device=dev),
                                      block_size=bs, plain=plain)
            outs.append(logits)
        torch.cuda.synchronize()
        if not plain:
            counts = dict(_cuda.COUNTS)
        runs.append(outs)
    pools = kv_quant or "bf16"
    for got, ref in zip(*runs):
        if not torch.isfinite(got).all():
            raise AssertionError(f"model ({pools} pools): non-finite logits through the kernels")
        err = (got - ref).abs().max().item()
        tol = 5e-2 * ref.abs().max().item()
        worst = max(worst, err / max(ref.abs().max().item(), 1e-30))
        if err > tol:
            raise AssertionError(f"model ({pools} pools): logits differ by {err} > {tol}")
    want = ("w4_matmul", "w8_matmul") + tuple(
        f"{k}_{kv_quant}" if kv_quant else k for k in ("paged_decode", "paged_prefill"))
    missing = [k for k in want if counts.get(k, 0) == 0]
    plain_run = {k: v for k, v in counts.items() if k.endswith("_plain") and v}
    if missing or plain_run:
        raise AssertionError(f"model ({pools} pools): kernels not launched {missing}, plain "
                             f"versions run {plain_run}")
    log(f"  model 2 layers, {pools} pools: 1 prefill (2x{t}) + {n_dec} decode steps, worst "
        f"|err|/max|logit| {worst:.3e} (tol 5e-2); kernel run launches {counts}")
    return counts


@contextlib.contextmanager
def recorded_routing(chosen: list, forced=None, gaps=None, logits_seen=None):
    """``llama.route`` records the experts it picks into ``chosen`` (sorted,
    ``[b, t, k]`` per layer and forward), and into ``gaps`` (when given) the
    router-logit gap at the top-k edge, the k-th largest logit less the
    (k+1)-th, and that gap in bf16 ulps of the k-th logit (``[b, t, 2]``:
    how near a tie the choice was); with ``forced``
    (another run's ``chosen``), it picks those experts instead, weighted
    from this run's own logits: routing over the logits of those experts
    alone gives the same weights as the router does when it picks them,
    but for qwen2moe without ``norm_topk_prob``, whose weights are the
    softmax over all experts at those experts. ``logits_seen`` (when given)
    collects the router logits of every call."""
    route = llama.route
    forced = None if forced is None else iter(forced)

    def recording_route(logits, cfg_):
        topw, topi = route(logits, cfg_)
        chosen.append(topi.sort(dim=-1).values)
        if logits_seen is not None:
            logits_seen.append(logits.clone())
        k = topi.shape[-1]
        if gaps is not None and k < logits.shape[-1]:
            edge = logits.topk(k + 1, dim=-1).values
            gap = edge[..., k - 1] - edge[..., k]
            ulp = torch.exp2(torch.floor(torch.log2(edge[..., k - 1].abs().clamp_min(1e-30))) - 7)
            gaps.append(torch.stack([gap, gap / ulp], dim=-1))
        if forced is None:
            return topw, topi
        idx = next(forced)
        if cfg_.arch == "qwen2moe" and not cfg_.norm_topk_prob:
            return torch.softmax(logits, dim=-1).gather(-1, idx), idx
        keep = torch.zeros_like(logits, dtype=torch.bool).scatter_(-1, idx, True)
        return route(logits.masked_fill(~keep, float("-inf")), cfg_)

    llama.route = recording_route
    try:
        yield
    finally:
        llama.route = route


NEAR_TIE_ULPS = 4  # phase 3g's rule: a choice that differs is a near-tie within this


def choice_agreement(what: str, kernel_run: list, plain_run: list, plain_gaps: list,
                     near_tie_ulps=None) -> tuple[int, int, list]:
    """``(same, total, gaps)``: the (token, layer) expert choices of two
    runs that agree, of all, and the plain run's router-logit gaps at the
    top-k edge (``recorded_routing``: ``[gap, gap in bf16 ulps]``) of those
    that do not, largest first. The gaps tell near-ties, which flip under
    another sum order, from a kernel fault that flips a clear choice. Fails
    under 99 % agreement (phases 3b and 3e), or, with ``near_tie_ulps``, if
    a choice that differs had a gap of more than that many bf16 ulps of the
    k-th logit (phase 3g: 128 experts top-8, whose bf16 router logits tie
    at the top-8 edge in about one (token, layer) in fifty)."""
    total = same = 0
    gaps: list = []
    for a, c, gap in zip(kernel_run, plain_run, plain_gaps):
        eq = (a == c).all(dim=-1)  # [b, t]
        total += eq.numel()
        same += int(eq.sum())
        gaps += gap[~eq].tolist()
    gaps.sort(reverse=True)
    rule = ("99 %" if near_tie_ulps is None
            else f"every one that differs within {near_tie_ulps} bf16 ulps of a tie")
    log(f"  {what}: expert choices agree {same}/{total} ({100 * same / total:.2f} %; rule: "
        f"{rule}); router-logit gaps at the top-k edge of the {len(gaps)} that differ (plain "
        f"run): " + (f"largest {gaps[0][0]:.3e} ({max(u for _, u in gaps):.2f} ulps), then "
                     + ", ".join(f"{g:.2e}" for g, _ in gaps[1:32]) if gaps else "none"))
    if near_tie_ulps is None and same < 0.99 * total:
        raise AssertionError(f"{what}: only {same}/{total} expert choices agree")
    if near_tie_ulps is not None and any(u > near_tie_ulps for _, u in gaps):
        raise AssertionError(f"{what}: a choice with a router-logit gap of "
                             f"{max(u for _, u in gaps):.2f} bf16 ulps differs (a near-tie "
                             f"is at most {near_tie_ulps})")
    return same, total, gaps


def router_noise(what: str, k: int, kernel_run: list, plain_run: list) -> tuple[str, float]:
    """How far the router logits of the kernel run and of the plain run (on
    the kernel run's expert choices, so the same path) lie apart: the
    largest |difference|, and the differences in bf16 ulps of each (token,
    layer)'s k-th largest logit, the top-k edge that a choice must cross to
    flip (the largest, and the 99th and 99.9th percentiles). Returns the
    log line and the largest difference in those ulps."""
    diffs, ulps = [], []
    for a, b in zip(kernel_run, plain_run):
        d = (a - b).float().abs().reshape(-1, a.shape[-1])
        edge = b.float().reshape(-1, b.shape[-1]).topk(k, dim=-1).values[:, -1:]
        diffs.append(d.flatten())
        ulps.append((d / torch.exp2(torch.floor(torch.log2(edge.abs().clamp_min(1e-30))) - 7))
                    .flatten())
    diff, ulp = torch.cat(diffs), torch.cat(ulps)
    q = torch.quantile(ulp[:1 << 24], torch.tensor([0.99, 0.999], device=ulp.device)).tolist()
    line = (f"router logits of the two runs differ by at most {diff.max().item():.3e} "
            f"({ulp.max().item():.2f} bf16 ulps of the row's top-k edge; 99th / 99.9th "
            f"percentile {q[0]:.2f} / {q[1]:.2f}) over {diff.numel()} logits")
    log(f"  {what}: {line}")
    return line + "; ", ulp.max().item()


def check_mixtral_model(dev) -> dict:
    """Phase 3b: 2 Mixtral layers at full width through the kernels and the
    plain versions; returns the kernel run's launch counts."""
    cfg = ModelConfig(**dict(MIXTRAL_8X7B, num_layers=2))
    weights = build_mixtral(cfg, dev, SEED + 4, down_kinds=("q6k", "bf16"))
    bs, b, t, n_dec = 64, 2, 96, 4
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    ids = torch.randint(0, cfg.vocab_size, (b, t + n_dec), generator=gen, device=dev)
    bt = torch.arange(b * 4, device=dev, dtype=torch.int32).reshape(b, 4)
    runs, choices, gaps = [], [], []
    counts: dict = {}
    for plain in (False, True):
        chosen: list = []
        gaps.append([])
        with recorded_routing(chosen, choices[0] if plain else None, gaps[-1]):
            cache = PagedKVCache.create(cfg, b * 4, bs, device=dev)
            _cuda.reset_counts()
            pos = torch.arange(t, device=dev)[None].expand(b, t)
            logits, _ = forward_paged(weights, cfg, ids[:, :t], pos, cache, bt,
                                      slots_for(bt, pos, bs), torch.full((b,), t, device=dev),
                                      block_size=bs, plain=plain)
            outs = [logits]
            for d in range(n_dec):
                p = torch.full((b, 1), t + d, device=dev)
                logits, _ = forward_paged(weights, cfg, ids[:, t + d:t + d + 1], p, cache, bt,
                                          slots_for(bt, p, bs),
                                          torch.full((b,), t + d + 1, device=dev),
                                          block_size=bs, plain=plain)
                outs.append(logits)
            torch.cuda.synchronize()
            if not plain:
                counts = dict(_cuda.COUNTS)
        runs.append(outs)
        choices.append(chosen)
    # agreement of the experts each path's own router chose per (token, layer)
    same, total, _ = choice_agreement("mixtral model", *choices, gaps[1])
    frac = same / total
    worst = 0.0
    for step, (got, ref) in enumerate(zip(*runs)):
        if not torch.isfinite(got).all():
            raise AssertionError("mixtral model: non-finite logits through the kernels")
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        worst = max(worst, err / max(scale, 1e-30))
        if err > 5e-2 * scale:
            raise AssertionError(f"mixtral model: step {step} logits differ by "
                                 f"{err} > {5e-2 * scale}")
    log(f"  mixtral 2 layers (Q6_K down, bf16 down): 1 prefill (2x{t}) + {n_dec} decode "
        f"steps; expert choices agree {same}/{total} ({100 * frac:.2f} %, need 99 %); "
        f"all {b * (n_dec + 1)} (row, step) logits compared on the kernel run's routing, "
        f"worst |err|/max|logit| {worst:.3e} (tol 5e-2); kernel run launches {counts}")
    want = ("w4_matmul_g", "w8_matmul_g", "dense_matmul_g", "w4_matmul", "w8_matmul",
            "paged_decode", "paged_prefill")
    missing = [k for k in want if counts.get(k, 0) == 0]
    plain_run = {k: v for k, v in counts.items() if k.endswith("_plain") and v}
    if missing or plain_run:
        raise AssertionError(f"mixtral model: kernels not launched {missing}, "
                             f"plain versions run {plain_run}")
    del weights
    return counts


def check_deepseek_model(dev) -> dict:
    """Phase 3c: 2 DeepSeek-V2-Lite layers at full width (the dense layer 0
    and one MoE layer) through the kernels and the plain versions, with
    phase 3b's rule on expert choices; then through the kernels over an int8
    latent pool (on the bf16 kernel run's expert choices): the gather path
    at every step, no MLA launch, logits within 5e-2 of the largest of the
    bf16 pool's (int8 keys: a step of amax / 127 a value). Returns the bf16
    kernel run's counts."""
    cfg = deepseek.DeepseekConfig(**dict(DEEPSEEK_V2_LITE, num_layers=2))
    weights = deepseek.init_random_weights(cfg, seed=SEED + 7, device=dev)
    bs, b, t, n_dec = 64, 2, 96, 4
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    ids = torch.randint(0, cfg.vocab_size, (b, t + n_dec), generator=gen, device=dev)
    bt = torch.arange(b * 4, device=dev, dtype=torch.int32).reshape(b, 4)
    runs, choices, run_counts = [], [], []
    select = deepseek.select_experts
    for plain, kv_quant in ((False, None), (True, None), (False, "int8")):
        chosen: list = []
        forced = iter(choices[0]) if choices else None

        def recording_select(cfg_, scores, biased, chosen=chosen, forced=forced):
            topw, topi = select(cfg_, scores, biased)
            chosen.append(topi.sort(dim=-1).values)
            if forced is None:
                return topw, topi
            # the kernel run's experts, weighted by this run's own scores
            keep = torch.zeros_like(scores).scatter_(-1, next(forced), 1.0)
            return select(cfg_, scores, keep)

        deepseek.select_experts = recording_select
        try:
            pool = deepseek.make_paged_cache(cfg, b * 4, bs, kv_quant=kv_quant, device=dev)
            _cuda.reset_counts()
            pos = torch.arange(t, device=dev)[None].expand(b, t)
            logits, _ = deepseek.deepseek_forward_paged(
                weights, cfg, ids[:, :t], pos, pool, bt, slots_for(bt, pos, bs),
                torch.full((b,), t, device=dev), block_size=bs, plain=plain)
            outs = [logits]
            for d in range(n_dec):
                p = torch.full((b, 1), t + d, device=dev)
                logits, _ = deepseek.deepseek_forward_paged(
                    weights, cfg, ids[:, t + d:t + d + 1], p, pool, bt, slots_for(bt, p, bs),
                    torch.full((b,), t + d + 1, device=dev), block_size=bs, plain=plain)
                outs.append(logits)
            torch.cuda.synchronize()
            run_counts.append(dict(_cuda.COUNTS))
        finally:
            deepseek.select_experts = select
        runs.append(outs)
        choices.append(chosen)
    counts = run_counts[0]
    total = same = 0
    for a, c in zip(choices[0], choices[1]):
        eq = (a == c).all(dim=-1)
        total += eq.numel()
        same += int(eq.sum())
    frac = same / total
    if frac < 0.99:
        raise AssertionError(f"deepseek model: only {same}/{total} expert choices agree")
    worst = 0.0
    for step, (got, ref) in enumerate(zip(runs[0], runs[1])):
        if not torch.isfinite(got).all():
            raise AssertionError("deepseek model: non-finite logits through the kernels")
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        worst = max(worst, err / max(scale, 1e-30))
        if err > 5e-2 * scale:
            raise AssertionError(f"deepseek model: step {step} logits differ by "
                                 f"{err} > {5e-2 * scale}")
    log(f"  deepseek-v2-lite 2 layers: 1 prefill (2x{t}) + {n_dec} decode steps; expert "
        f"choices agree {same}/{total} ({100 * frac:.2f} %, need 99 %); all "
        f"{b * (n_dec + 1)} (row, step) logits compared on the kernel run's routing, worst "
        f"|err|/max|logit| {worst:.3e} (tol 5e-2); kernel run launches {counts}")
    missing = [k for k in DEEPSEEK_KERNELS if counts.get(k, 0) == 0]
    plain_run = {k: v for k, v in counts.items() if k.endswith("_plain") and v}
    if missing or plain_run:
        raise AssertionError(f"deepseek model: kernels not launched {missing}, "
                             f"plain versions run {plain_run}")
    # the int8 latent pool against the bf16 pool, both through the kernels
    q8 = run_counts[2]
    worst_q = 0.0
    for step, (got, ref) in enumerate(zip(runs[2], runs[0])):
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        worst_q = max(worst_q, err / max(scale, 1e-30))
        if not torch.isfinite(got).all() or err > 5e-2 * scale:
            raise AssertionError(f"deepseek model, int8 latent pool: step {step} logits differ "
                                 f"from the bf16 pool's by {err} > {5e-2 * scale}")
    plain_q = {k: v for k, v in q8.items() if k.endswith("_plain") and v}
    if q8.get("mla_decode", 0) or plain_q or not q8.get("dense_matmul_g", 0):
        raise AssertionError(f"deepseek model, int8 latent pool: launches {q8} (want no MLA "
                             f"decode, no plain version, the dense grouped kernel)")
    log(f"  deepseek-v2-lite 2 layers, int8 latent pool (gather path): 1 prefill + {n_dec} "
        f"decode steps on the bf16 run's expert choices, worst |err|/max|logit| against the "
        f"bf16 pool's {worst_q:.3e} (tol 5e-2); no MLA launch; launches {q8}")
    del weights
    return counts


def check_gemma_model(dev) -> dict:
    """Phase 3d: 2 Gemma-2-9B layers at full width (layer 0 sliding with its
    4096-position window, layer 1 full; both softcaps; head_dim 256) through
    the kernels and through the plain versions on the same device weights,
    over bf16, int8 and fp8 pools: one row with a 4160-token prompt in
    512-token chunks (its last chunk passes position 4096, where the window
    starts to hide positions), one row with a 100-token prompt, then 4
    decode steps of both rows (the sliding layer's decode walk then starts
    past the first tile); every step's logits within 5e-2 of the largest.
    Returns the kernel runs' launch counts by ``kv_quant``."""
    cfg = ModelConfig(**dict(GEMMA2_9B, num_layers=2))
    weights = build_gemma(cfg, dev, SEED + 10)
    counts = {kvq: check_gemma_pools(dev, cfg, weights, kvq) for kvq in (None, "int8", "fp8")}
    del weights
    return counts


def check_gemma_pools(dev, cfg, weights, kv_quant) -> dict:
    bs, chunk, n_dec = 64, 512, 4
    lens = (4160, 100)
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    ids = torch.randint(0, cfg.vocab_size, (2, max(lens) + n_dec), generator=gen, device=dev)
    w = -(-(max(lens) + n_dec) // bs)
    bt = torch.arange(2 * w, device=dev, dtype=torch.int32).reshape(2, w)
    runs, counts = [], {}
    for plain in (False, True):
        cache = PagedKVCache.create(cfg, 2 * w, bs, kv_quant=kv_quant, device=dev)
        _cuda.reset_counts()
        outs = []
        for row, n in enumerate(lens):
            tb = bt[row:row + 1]
            for lo in range(0, n, chunk):
                hi = min(lo + chunk, n)
                pos = torch.arange(lo, hi, device=dev)[None]
                logits, _ = forward_paged(weights, cfg, ids[row:row + 1, lo:hi], pos, cache, tb,
                                          slots_for(tb, pos, bs), torch.tensor([hi], device=dev),
                                          block_size=bs, plain=plain)
                outs.append(logits)
        kv = torch.tensor(lens, device=dev)
        for d in range(n_dec):
            p = (kv + d)[:, None]
            logits, _ = forward_paged(weights, cfg, ids.gather(1, p), p, cache, bt,
                                      slots_for(bt, p, bs), kv + d + 1, block_size=bs,
                                      plain=plain)
            outs.append(logits)
        torch.cuda.synchronize()
        if not plain:
            counts = dict(_cuda.COUNTS)
        runs.append(outs)
    worst = 0.0
    pools = kv_quant or "bf16"
    for step, (got, ref) in enumerate(zip(*runs)):
        if not torch.isfinite(got).all():
            raise AssertionError(f"gemma model ({pools} pools): step {step}: non-finite logits "
                                 f"through the kernels")
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        worst = max(worst, err / max(scale, 1e-30))
        if err > 5e-2 * scale:
            raise AssertionError(f"gemma model ({pools} pools): step {step} logits differ by "
                                 f"{err} > {5e-2 * scale}")
    missing = [k for k in quant_names(GEMMA_KERNELS, kv_quant) if counts.get(k, 0) == 0]
    plain_run = {k: v for k, v in counts.items() if k.endswith("_plain") and v}
    if missing or plain_run:
        raise AssertionError(f"gemma model ({pools} pools): kernels not launched {missing}, "
                             f"plain versions run {plain_run}")
    log(f"  gemma-2-9b 2 layers (window 4096, full), {pools} pools: prefill of {lens[0]} tokens "
        f"in chunks of {chunk} and of {lens[1]}, {n_dec} decode steps of both rows; worst "
        f"|err|/max|logit| {worst:.3e} (tol 5e-2); kernel run launches {counts}")
    return counts


def two_layer_runs(dev, cfg, weights, seed: int, what: str, required,
                   near_tie_ulps=None, kv_quant=None, control=None, forced=None) -> tuple:
    """``cfg``'s 2 layers through the kernels and through the plain versions
    on the same device weights (``kv_quant``: the pools' codes): two
    300-token prompts in 128-token chunks, then 4 decode steps of both rows;
    with experts, phase 3b's rule on expert choices or, with
    ``near_tie_ulps``, the near-tie rule of ``choice_agreement`` (their
    router-logit gaps logged either way; ``near_tie_ulps="noise"``: within
    twice the largest difference of the two runs' router logits on one
    path, in the same ulps, and at least ``NEAR_TIE_ULPS``: phase 3m's
    quantized routers, whose product the kernel takes on f32 weights and
    the plain version on bf16-rounded ones), then the plain run on the kernel
    run's choices; every step's logits within 5e-2 of the largest, every
    kernel of ``required`` (in its ``kv_quant`` form) launched and no plain
    version in the kernel run. With ``forced`` (another run's expert
    choices), both runs take those choices and no rule is applied to them
    (phase 3c's int8 latent pool does the same: a 1-byte cache quantizes
    the two paths' slightly different K/V rows to codes a step apart, which
    flips more near-ties). With ``control`` (another config of the same
    weights), a third run through the kernels whose logits must move, at
    some step, by more than ten times the kernel run's worst difference
    from the plain run (both relative to the largest logit). Returns ``(kernel run
    launch counts, log note, the kernel run's expert choices)``."""
    bs, b, n, chunk, n_dec = 64, 2, 300, 128, 4
    gen = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(0, cfg.vocab_size, (b, n + n_dec), generator=gen, device=dev)
    w = -(-(n + n_dec) // bs)
    bt = torch.arange(b * w, device=dev, dtype=torch.int32).reshape(b, w)
    runs, choices, gaps, counts, router = [], [], [], {}, []

    def run(run_cfg, plain):
        cache = PagedKVCache.create(run_cfg, b * w, bs, kv_quant=kv_quant, device=dev)
        outs = []
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            pos = torch.arange(lo, hi, device=dev)[None].expand(b, hi - lo)
            logits, _ = forward_paged(weights, run_cfg, ids[:, lo:hi], pos, cache, bt,
                                      slots_for(bt, pos, bs), torch.full((b,), hi, device=dev),
                                      block_size=bs, plain=plain)
            outs.append(logits)
        for d in range(n_dec):
            p = torch.full((b, 1), n + d, device=dev)
            logits, _ = forward_paged(weights, run_cfg, ids[:, n + d:n + d + 1], p, cache, bt,
                                      slots_for(bt, p, bs),
                                      torch.full((b,), n + d + 1, device=dev),
                                      block_size=bs, plain=plain)
            outs.append(logits)
        torch.cuda.synchronize()
        return outs

    for plain in (False, True):
        chosen: list = []
        gaps.append([])
        force = forced if forced is not None else choices[0] if plain else None
        router.append([])
        with recorded_routing(chosen, force, gaps[-1], router[-1]):
            _cuda.reset_counts()
            outs = run(cfg, plain)
            if not plain:
                counts = dict(_cuda.COUNTS)
        runs.append(outs)
        choices.append(chosen)
    note = ""
    if cfg.num_experts:
        note, noise_ulps = router_noise(what, cfg.num_experts_per_tok, *router)
        if near_tie_ulps == "noise":  # phase 3m's quantized routers: ties within the noise
            near_tie_ulps = max(NEAR_TIE_ULPS, 2 * noise_ulps)
    if cfg.num_experts and forced is not None:
        note += "on the bf16 pools' kernel run's expert choices; "
    elif cfg.num_experts:
        same, total, near = choice_agreement(what, *choices, gaps[1], near_tie_ulps)
        note += (f"expert choices agree {same}/{total} ({100 * same / total:.2f} %; largest "
                f"gap of those that differ {near[0][0] if near else 0.0:.3e}); ")
    worst = 0.0
    for step, (got, ref) in enumerate(zip(*runs)):
        if not torch.isfinite(got).all():
            raise AssertionError(f"{what}: step {step}: non-finite logits through the kernels")
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        worst = max(worst, err / max(scale, 1e-30))
        if err > 5e-2 * scale:
            raise AssertionError(f"{what}: step {step} logits differ by {err} > {5e-2 * scale}")
    missing = [k for k in quant_names(required, kv_quant) if counts.get(k, 0) == 0]
    plain_run = {k: v for k, v in counts.items() if k.endswith("_plain") and v}
    if missing or plain_run:
        raise AssertionError(f"{what}: kernels not launched {missing}, plain versions run "
                             f"{plain_run}")
    note += (f"{kv_quant or 'bf16'} pools, prefill of {b} x {n} tokens in chunks of {chunk}, "
             f"{n_dec} decode steps; worst |err|/max|logit| {worst:.3e} (tol 5e-2)"
             + (" on the kernel run's routing" if cfg.num_experts and forced is None else ""))
    if control is not None:
        moved = max((a - c).abs().max().item() / max(c.abs().max().item(), 1e-30)
                    for a, c in zip(run(control, False), runs[0]))
        if not moved > 10 * worst:
            raise AssertionError(f"{what}: the control config moves the logits by {moved} of the "
                                 f"largest only (needs > {10 * worst}, ten times the kernels' "
                                 f"worst difference)")
        note += (f"; the control config moves the logits {moved:.3e} of the largest (> "
                 f"{10 * worst:.3e}, ten times the kernels' worst difference)")
    return counts, note + f"; kernel run launches {counts}", choices[0]


# phase 3n's runs: each variant's pools, and the Phi models over every pool type
VARIANT_RUNS = (("phi3", (None, "int8", "fp8")), ("phi2", (None, "int8", "fp8")),
                ("starcoder2", (None,)), ("stablelm", (None,)), ("cohere", (None,)),
                ("granite", (None,)), ("glm4", (None,)), ("smollm3", (None,)))


def check_variant_models(dev) -> dict:
    """Phase 3n: 2 layers at full width of each Llama-family variant of
    :data:`VARIANT_RUNS` (its published geometry, its features kept:
    SmolLM3's second layer a NoPE one), drawn as a bf16 HF checkpoint and
    loaded through the HF loader (:func:`build_variant`), through the
    kernels and the plain versions (``two_layer_runs``: logits within 5e-2
    of the largest, the paged forms of the arch's head dim launched, no
    plain version in the kernel run), Phi-3-mini and Phi-2 over bf16, int8
    and fp8 pools. Returns the kernel runs' launch counts by (arch,
    ``kv_quant``)."""
    counts = {}
    for i, (kind, pools) in enumerate(VARIANT_RUNS):
        cfg = variant_config(kind, 2)
        weights = build_variant(cfg, dev, SEED + 70 + 2 * i)
        required = tuple(attn_name(k, None, cfg.head_dim) for k in ("paged_decode",
                                                                     "paged_prefill"))
        for kvq in pools:
            counts[(kind, kvq)], note, _ = two_layer_runs(dev, cfg, weights, SEED + 71 + 2 * i,
                                                          f"{kind} model", required,
                                                          kv_quant=kvq)
            log(f"  {kind} 2 layers (hidden {cfg.hidden_size}, {cfg.num_heads}/"
                f"{cfg.num_kv_heads} heads of {cfg.head_dim}): {note}")
        del weights
        torch.cuda.empty_cache()
    return counts


def check_gpt_oss_model(dev) -> dict:
    """Phase 3e: 2 gpt-oss-20b layers at full width (layer 0 sliding with
    its 128-position window, layer 1 full; sinks, biases, YaRN, head_dim 64,
    32 bf16 experts top-4) through the kernels and the plain versions
    (``two_layer_runs``: the chunks pass the window's edge), over bf16, int8
    and fp8 pools (these two on the bf16 run's expert choices, as phase 3c's
    int8 latent pool). Returns the kernel runs' launch counts by
    ``kv_quant``."""
    cfg = ModelConfig(**dict(GPT_OSS_20B, num_layers=2,
                             layer_types=GPT_OSS_20B["layer_types"][:2]))
    weights = build_gpt_oss(cfg, dev, SEED + 13)
    counts, chosen = {}, None
    for kvq in (None, "int8", "fp8"):
        counts[kvq], note, choices = two_layer_runs(dev, cfg, weights, SEED + 14,
                                                    "gpt-oss model", GPT_OSS_KERNELS,
                                                    kv_quant=kvq, forced=chosen)
        chosen = chosen or choices
        log(f"  gpt-oss-20b 2 layers (window 128, full): {note}")
    del weights
    return counts


def check_gemma3_model(dev) -> dict:
    """Phase 3h: 2 Gemma-3-27B layers at full width (layer 0 sliding with
    its 1024-position window and the local rope base, layer 1 full with the
    global base and linear scaling 8; head_dim 128, 32/16 heads, a scale of
    168^-0.5, q/k norms) through the kernels and the plain versions over fp8
    pools (``two_layer_runs``), and a control: the same weights with the
    two rope bases swapped move the logits. Returns the kernel run's launch
    counts."""
    cfg = ModelConfig(**dict(GEMMA3_27B, num_layers=2,
                             layer_types=["sliding_attention", "full_attention"]))
    swapped = ModelConfig(**dict(vars(cfg), rope_theta=cfg.rope_local_theta,
                                 rope_local_theta=cfg.rope_theta))
    weights = build_gemma(cfg, dev, SEED + 22)
    counts, note, _ = two_layer_runs(dev, cfg, weights, SEED + 23, "gemma-3-27b model",
                                     QWEN_KERNELS, kv_quant="fp8", control=swapped)
    log(f"  gemma-3-27b 2 layers (window 1024, full): {note}")
    del weights
    return counts


def check_qwen_model(dev, base: dict, seed: int, what: str, required) -> dict:
    """Phases 3f and 3g: 2 layers of ``base`` at full width through the
    kernels and the plain versions (``two_layer_runs``): Qwen2.5-7B (q/k/v
    biases; GQA group 7, so a 128-token chunk fills 14 query tiles of 9
    tokens and 2 tokens of a fifteenth) and Qwen3-30B-A3B (q/k norm, q_dim
    4096 against a hidden 2048, 128 bf16 experts top-8 on the dense grouped
    kernel; the near-tie rule on its expert choices). Returns the kernel
    run's launch counts."""
    cfg = ModelConfig(**dict(base, num_layers=2))
    weights = build_qwen(cfg, dev, seed)
    counts, note, _ = two_layer_runs(dev, cfg, weights, seed + 1, what, required,
                                     NEAR_TIE_ULPS if cfg.num_experts else None)
    log(f"  {what} 2 layers: {note}")
    del weights
    return counts


def check_wide_model(dev, qc: dict, seed: int, what: str, required) -> dict:
    """Phase 3i: 2 layers at full Qwen2.5-7B width as its GPTQ checkpoint
    ``qc`` stores them (:func:`build_quantized`) through the kernels and the
    plain versions (``two_layer_runs``): the wide-group form of ``required``
    in both its bodies (decode and prefill), no plain version in the kernel
    run. Returns the kernel run's launch counts."""
    cfg = ModelConfig(**dict(QWEN25_7B, num_layers=2))
    weights = build_quantized(cfg, dev, seed, qc)
    lw = weights["layers"][0]
    check(all(isinstance(lw[k], QTensor) and lw[k].group_size == 128 for k in
              ("wqkv", "wo", "wgateup", "down")) and "wqkv_bias" in lw,
          f"{what}: projections not fused planar QTensors of group 128 with q/k/v biases")
    counts, note, _ = two_layer_runs(dev, cfg, weights, seed + 1, what, required)
    bodies = {b: counts.get(f"{required[0]}.{b}", 0) for b in ("decode", "prefill")}
    check(all(bodies.values()), f"{what}: {required[0]} bodies launched {bodies}")
    log(f"  {what} 2 layers: {note}")
    del weights
    return counts


def check_quantized_moe_model(dev, base: dict, qc: dict, seed: int, what: str, required,
                              near_tie_ulps=None) -> dict:
    """Phases 3j and 3k: 2 layers at full width of ``base`` as its GPTQ or
    AWQ checkpoint ``qc`` stores them (:func:`build_quantized`: the experts
    decoded one by one and stacked into banks of group 128) through the
    kernels and the plain versions (``two_layer_runs``; ``near_tie_ulps``:
    phase 3g's rule on expert choices, else phase 3b's), then the plain run
    on the kernel run's choices: Qwen1.5-MoE-A2.7B
    GPTQ-Int4 (W4 grouped gate/up, W8 grouped down, the W4 wide form for
    attention and the gated shared expert) and Mixtral-8x7B AWQ (W4 grouped
    for both banks). Every grouped wide form of ``required`` in both its
    bodies, no plain version in the kernel run. Returns the kernel run's
    launch counts."""
    cfg = ModelConfig(**dict(base, num_layers=2))
    weights = build_quantized(cfg, dev, seed, qc)
    ex = weights["layers"][0]["experts"]
    check(set(ex) == {"gateup", "down"} and all(
        isinstance(b, QTensor) and b.group_size == 128 and b.num_banks == cfg.num_experts
        for b in ex.values()), f"{what}: expert banks not fused planar banks of group 128")
    counts, note, _ = two_layer_runs(dev, cfg, weights, seed + 1, what, required, near_tie_ulps)
    grouped = [k for k in required if k.endswith("_wide_g")]
    bodies = {f"{k}.{b}": counts.get(f"{k}.{b}", 0) for k in grouped
              for b in ("decode", "prefill")}
    check(all(bodies.values()), f"{what}: grouped bodies launched {bodies}")
    log(f"  {what} 2 layers: {note}")
    del weights
    return counts


def check_planarizers(dev) -> None:
    """Phase 3l's planarizer check: a tensor of every planar type drawn on
    the device and decomposed there and on the CPU (the same bytes): codes,
    scales and biases bit-equal."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 44)
    for t in ("Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q8_0", "Q2_K", "Q3_K", "Q4_K", "Q5_K", "Q6_K"):
        raw = draw_blocks(GGMLType[t], (2048, 4096), gen, dev)
        a = gguf_planar.to_planar(raw, GGMLType[t])
        b = gguf_planar.to_planar(raw.cpu(), GGMLType[t])
        for f in ("q", "scale", "bias"):
            x, y = getattr(a, f), getattr(b, f)
            same = (x is None and y is None) or (
                x is not None and y is not None and x.dtype == y.dtype
                and torch.equal(x.cpu().view(torch.uint8), y.view(torch.uint8)))
            check(same, f"{t}: the card's {f} plane differs from the CPU's")
    log("  planarizers: every type's codes, scales and biases on the card bit-equal to the "
        "CPU's (2048 x 4096 each)")


def check_gguf_model(dev, base: dict, type_of, seed: int, what: str, required,
                     near_tie_ulps=None) -> dict:
    """Phase 3l: 2 full-width layers of ``base`` as a GGUF file in the mix
    ``type_of`` stores them (:func:`build_gguf`, through
    ``load_gguf_model``), through the kernels and the plain versions
    (``two_layer_runs``; ``near_tie_ulps``: phase 3g's rule on expert
    choices): every kernel of ``required`` launched, and each W4 form of
    it in both bodies. Returns the kernel run's launch counts."""
    cfg = gguf_config(dict(base, num_layers=2))
    weights = build_gguf(cfg, dev, seed, type_of)
    counts, note, _ = two_layer_runs(dev, cfg, weights, seed + 1, what, required, near_tie_ulps)
    bodies = {f"{k}.{b}": counts.get(f"{k}.{b}", 0) for k in required if k.startswith("w")
              for b in ("decode", "prefill")}
    check(all(bodies.values()), f"{what}: bodies launched {bodies}")
    log(f"  {what} 2 layers: {note}")
    del weights
    return counts


def check_isq_bytes(dev) -> dict:
    """Phase 3m's quantizer check: a 1024 x 4096 f32 tensor drawn on the
    device (N(0, 0.02^2) rows, an all-zero and a constant super-block,
    all-positive groups, rows whose f16 ``d`` is subnormal) quantized there
    to each ISQ type (and to Q4_K with importance weights) and on the CPU:
    the bytes must be equal. Returns each type's card time per million
    weights (ms; the second of two calls, one chunk)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 56)
    x = torch.randn((1024, 4096), generator=gen, device=dev) * 0.02
    x[1, :256] = 0.0
    x[2, :256] = -0.25
    x[3] = x[3].abs() + 0.05
    x[4:8] *= 5e-3
    imp = torch.rand(4096, generator=gen, device=dev) ** 3
    xc, impc = x.cpu(), imp.cpu()
    rates = {}
    for name in ISQ_TYPES + ("Q4_K+imatrix",):
        t = GGMLType[name.split("+")[0]]
        w, wc = (imp, impc) if "imatrix" in name else (None, None)
        card = quantize(x, t, w)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        quantize(x, t, w)
        torch.cuda.synchronize()
        rates[name] = (time.monotonic() - t0) * 1e3 / (x.numel() / 1e6)
        # the CPU's bytes 256 rows at a time (whole rows of blocks: the same
        # bytes), so its temporaries stay small in host memory
        cpu = torch.cat([quantize(xc[i:i + 256], t, wc).reshape(-1)
                         for i in range(0, xc.shape[0], 256)])
        nb = cpu.numel() // type_traits(t).type_size
        differ = int((card.cpu().reshape(nb, -1) != cpu.reshape(nb, -1)).any(dim=1).sum())
        check(differ == 0, f"ISQ {name}: {differ} of {nb} blocks on the card differ from the CPU's")
    log("  ISQ bytes: every type on the card bit-equal to the CPU (1024 x 4096 each); card ms "
        "per million weights: " + ", ".join(f"{k} {v:.3f}" for k, v in rates.items()))
    return rates


def check_isq_model(dev, base: dict, seed: int, what: str, required,
                    near_tie_ulps=None) -> dict:
    """Phase 3m: 2 layers at full width of ``base`` as a bf16 checkpoint
    quantized in situ to Q4_K at load (:func:`build_isq`) through the
    kernels and the plain versions (``two_layer_runs``; ``near_tie_ulps``:
    phase 3g's near-tie rule on expert choices, ``"noise"`` for its
    threshold from the runs' router-logit noise; else phase 3b's): the router a
    padded Q4_K matrix on W4, W4 and W4 grouped in both bodies, every
    kernel of ``required`` launched and no plain version in the kernel run.
    Returns the kernel run's launch counts."""
    cfg = ModelConfig(**dict(base, num_layers=2))
    weights = build_isq(cfg, dev, seed)
    router = weights["layers"][0]["router"]
    check(isinstance(router, QTensor) and router.logical_n == cfg.num_experts
          and router.out_features % 16 == 0,
          f"{what}: the router is not a padded planar matrix of {cfg.num_experts} rows")
    counts, note, _ = two_layer_runs(dev, cfg, weights, seed + 1, what, required, near_tie_ulps)
    bodies = {f"{k}.{b}": counts.get(f"{k}.{b}", 0) for k in ("w4_matmul", "w4_matmul_g")
              for b in ("decode", "prefill")}
    check(all(bodies.values()), f"{what}: bodies launched {bodies}")
    log(f"  {what} 2 layers: {note}")
    del weights
    return counts


# ---------------------------------------------------------------------------
# phase 3o: the contiguous-cache forward
# ---------------------------------------------------------------------------


def contiguous_runs(dev, cfg, weights, ids, chunks, n_dec, make_cache, what: str,
                    required) -> dict:
    """Phase 3o on one model: ``ids [1, sum(chunks) + n_dec]`` as a chunked
    prefill then ``n_dec`` decode steps through ``llama.forward`` over
    ``make_cache()`` (each step's last-token logits), three times: through
    the kernels, through the plain versions (``plain=True``), and through
    ``forward_paged`` and its kernels over a paged cache of 64-token blocks
    with the same chunks. An MoE model's plain and paged runs take the
    kernel run's expert choices (phase 3b checks the router's own). Every
    step's logits of the plain run within 5e-2 of the largest of the kernel
    run's (phase 3's tolerance); of the paged run within 5e-2 too: the two
    forwards share the layer body and the W4/W8 kernels and differ only in
    attention, the f32 ``sdpa`` against the paged kernels (exp2, P as two
    bf16 parts), which phase 3 already holds to that tolerance against
    their plain versions, and both store K/V in bf16. Every kernel of
    ``required`` launched in the kernel run, no plain version. Returns the
    kernel run's launch counts."""
    bs = 64
    total = sum(chunks) + n_dec
    w = -(-total // bs)
    bt = torch.arange(w, device=dev, dtype=torch.int32)[None]
    choices: list = []
    runs, counts = {}, {}
    for mode in ("kernels", "plain", "paged"):
        chosen: list = []
        forced = None if mode == "kernels" else choices
        with recorded_routing(chosen, forced) if cfg.num_experts else contextlib.nullcontext():
            paged = mode == "paged"
            cache = PagedKVCache.create(cfg, w, bs, device=dev) if paged else make_cache()
            _cuda.reset_counts()
            outs, p = [], 0
            for c in list(chunks) + [1] * n_dec:
                pos = torch.arange(p, p + c, device=dev)[None]
                if paged:
                    logits, _ = forward_paged(weights, cfg, ids[:, p:p + c], pos, cache, bt,
                                              slots_for(bt, pos, bs),
                                              torch.tensor([p + c], device=dev), block_size=bs)
                else:
                    logits, _ = llama.forward(weights, cfg, ids[:, p:p + c], pos, cache, [p],
                                              logits_last_only=True, plain=mode == "plain")
                outs.append(logits)
                p += c
            torch.cuda.synchronize()
            if mode == "kernels":
                counts = dict(_cuda.COUNTS)
                choices = chosen
            del cache
        runs[mode] = outs
    worst = {}
    for mode in ("plain", "paged"):
        worst[mode] = 0.0
        for step, (got, ref) in enumerate(zip(runs["kernels"], runs[mode])):
            if not (torch.isfinite(got).all() and torch.isfinite(ref).all()):
                raise AssertionError(f"{what}: step {step}: non-finite logits ({mode} run)")
            err = (got - ref).abs().max().item()
            scale = ref.abs().max().item()
            worst[mode] = max(worst[mode], err / max(scale, 1e-30))
            if err > 5e-2 * scale:
                raise AssertionError(f"{what}: step {step}: the kernel run's logits differ from "
                                     f"the {mode} run's by {err} > {5e-2 * scale}")
    missing = [k for k in required if counts.get(k, 0) == 0]
    plain_run = {k: v for k, v in counts.items() if k.endswith("_plain") and v}
    if missing or plain_run:
        raise AssertionError(f"{what}: kernels not launched {missing}, plain versions run "
                             f"{plain_run}")
    log(f"  {what}: prefill of {sum(chunks)} tokens in chunks of {max(chunks)}, {n_dec} decode "
        f"steps; worst |err|/max|logit| against the plain run {worst['plain']:.3e}, against "
        f"forward_paged {worst['paged']:.3e} (tol 5e-2 each"
        + ("; on the kernel run's expert choices" if cfg.num_experts else "")
        + f"); kernel run launches {counts}")
    return counts


def check_contiguous_models(dev) -> dict:
    """Phase 3o: ``llama.forward`` over the contiguous caches at full width,
    2 layers of each model (:func:`contiguous_runs`): Llama-3-8B with Q4_K
    projections and a Q8_0 head over ``KVCache`` (two 256-token chunks),
    Mixtral-8x7B Q4_K_M (Q4_K gate/up banks, a Q6_K down bank on layer 0 and
    a Q4_K one on layer 1: grouped W4 and W8) over ``KVCache``, and
    Gemma-2-9B in bf16 (layer 0 sliding with its 4096 window, layer 1 full;
    softcaps, head_dim 256) over ``HybridKVCache`` with a 4400-token prompt
    in chunks of 1024, so that the ring wraps. Returns each model's kernel
    run launch counts."""
    out = {}
    cfg = ModelConfig(**dict(LLAMA3_8B, num_layers=2))
    weights = build_weights(cfg, dev, SEED + 94)
    gen = torch.Generator(device=dev).manual_seed(SEED + 95)
    ids = torch.randint(0, cfg.vocab_size, (1, 516), generator=gen, device=dev)
    out["llama"] = contiguous_runs(
        dev, cfg, weights, ids, (256, 256), 4,
        lambda: llama.KVCache.create(cfg, 1, 516, device=dev),
        "llama-3-8b q4_k, contiguous", ("w4_matmul", "w8_matmul"))
    del weights
    torch.cuda.empty_cache()
    cfg = ModelConfig(**dict(MIXTRAL_8X7B, num_layers=2))
    weights = build_mixtral(cfg, dev, SEED + 96, down_kinds=("q6k", "q4k"))
    ids = torch.randint(0, cfg.vocab_size, (1, 516), generator=gen, device=dev)
    out["mixtral"] = contiguous_runs(
        dev, cfg, weights, ids, (256, 256), 4,
        lambda: llama.KVCache.create(cfg, 1, 516, device=dev),
        "mixtral-8x7b q4_k_m, contiguous", ("w4_matmul_g", "w8_matmul_g", "w4_matmul",
                                            "w8_matmul"))
    del weights
    torch.cuda.empty_cache()
    cfg = ModelConfig(**dict(GEMMA2_9B, num_layers=2))
    weights = build_gemma(cfg, dev, SEED + 97)
    ids = torch.randint(0, cfg.vocab_size, (1, 4404), generator=gen, device=dev)
    cache_box = []

    def hybrid():
        cache_box.append(llama.HybridKVCache.create(cfg, 1, 4404, device=dev))
        return cache_box[-1]

    out["gemma"] = contiguous_runs(dev, cfg, weights, ids, (1024,) * 4 + (304,), 4, hybrid,
                                   "gemma-2-9b bf16, hybrid cache", ())
    ring = cache_box[0].slot_pos
    check(int(ring.min()) == 4404 - 4096 and int(ring.max()) == 4403,
          f"phase 3o: the ring holds positions {int(ring.min())}..{int(ring.max())}, not the "
          f"last 4096 (308..4403)")
    del weights, cache_box
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the weight formats (phase 2's FP8 and HQQ rows, phases 3p, 20 and 21): FP8
# on the W8 kernel's e4m3 form, HQQ on the W4 kernel's wide form,
# bitsandbytes NF4, UQFF files of both kinds, topologies, GGUF export
# ---------------------------------------------------------------------------

FP8_KERNELS = ("w8_matmul_e4m3", "paged_decode", "paged_prefill")
HQQ_KERNELS = ("w4_matmul_wide", "paged_decode", "paged_prefill")
PROJECTIONS = ("wq", "wk", "wv", "wo", "gate", "up", "down")
# meta-llama/Llama-3.1-8B-Instruct's config.json, for the HF directories
# phase 3p writes
LLAMA31_8B_JSON = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama", "hidden_size": 4096,
    "intermediate_size": 14336, "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 8, "head_dim": 128, "rms_norm_eps": 1e-5, "rope_theta": 500000.0,
    "max_position_embeddings": 131072, "vocab_size": 128256, "tie_word_embeddings": False,
    "bos_token_id": 128000, "eos_token_id": [128001, 128008, 128009],
    "rope_scaling": {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                     "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
}


# (N, K, row counts) of phase 2's FP8 and HQQ rows: Llama-3.1-8B's gate-up and down
FORMAT_SHAPES = ((28672, 4096, (8, 512)), (4096, 14336, (8,)))


def check_fp8_hqq(rows, rates, gen, dev):
    """Phase 2's rows of the weight formats at Llama-3.1-8B's gate-up (M 8
    and 512: N 28672, K 4096) and down (M 8: N 4096, K 14336): the W8
    kernel's e4m3 form at 128 x 128 block scales and at a per-tensor scale
    (the decode body at M 8, the prefill body at 512), and the same weights
    as HQQ-4 at group 64 on the W4 kernel's wide form, timed as the other
    W4/W8 rows are; then untimed, e4m3 at M 1 and 17 and at block 64."""
    for n, k, ms in FORMAT_SHAPES:
        w = torch.randn((n, k), generator=gen, device=dev) * k ** -0.5
        for blocks in ((128, 128), None):
            fw = Fp8Tensor.quantize(w, blocks, device=dev)
            for m in ms:
                r = check_matmul("w8_matmul_e4m3", m, fw, rates, gen, dev)
                r["shape"] += " blockwise 128x128" if blocks else " per-tensor"
                rows["w8_matmul_e4m3"].append(r)
            del fw
        hq = hqq_quantize(w, 4, 64, device=dev)
        for m in ms:
            r = check_matmul("w4_matmul_wide", m, hq, rates, gen, dev)
            r["shape"] += " HQQ-4 group 64"
            rows["w4_matmul_wide"].append(r)
        del w, hq
    w = torch.randn((1024, 4096), generator=gen, device=dev) / 64
    for blocks in ((128, 128), (64, 64), None):
        fw = Fp8Tensor.quantize(w, blocks, device=dev)
        for m in (1, 17):
            r = check_matmul("w8_matmul_e4m3", m, fw, rates, gen, dev, timed=False,
                             out_dtype=torch.float32 if m == 17 else None)
            r["shape"] += f" blocks {blocks}"
            rows["w8_matmul_e4m3"].append(r)


def dense_llama(cfg, dev, seed: int) -> dict:
    """``cfg``'s weights as a bf16 checkpoint (:func:`bf16_checkpoint`)
    through the HF loader, unfused (the projections dense bf16)."""
    sd = bf16_checkpoint(cfg, dev, seed)
    weights = hf_loader.weights_from_state_dict(sd, cfg, device=dev)
    del sd
    return weights


def requantize(weights: dict, fn) -> float:
    """Each layer's projections replaced by ``fn(weight)`` in place, the
    bf16 weight released as it goes; returns the seconds taken."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for lw in weights["layers"]:
        for key in PROJECTIONS:
            lw[key] = fn(lw[key])
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    torch.cuda.empty_cache()
    return dt


def build_fp8(cfg, dev, seed: int, stats: dict | None = None) -> dict:
    """``cfg``'s projections in blockwise FP8 (128 x 128 scales, quantized on
    the card from a bf16 checkpoint), the embedding and head bf16, fused
    (q/k/v, gate/up: whole blocks of 128 rows each)."""
    weights = dense_llama(cfg, dev, seed)
    dt = requantize(weights, lambda w: Fp8Tensor.quantize(w, (128, 128), device=dev))
    if stats is not None:
        stats["seconds"] = dt
    return llama.fuse_projections(weights, cfg)


def build_hqq_uqff(cfg, dev, seed: int, stats: dict) -> dict:
    """Phase 20's weights: ``cfg``'s projections quantized on the card to
    HQQ-4 at group 64 from a bf16 checkpoint (the embedding and head bf16),
    fused, written with ``save_uqff`` to a temporary directory, then loaded
    back through ``load_pipeline`` of the ``.uqff`` file (the file deleted
    after); ``stats`` gets the HQQ, write and read seconds and the file's
    size."""
    weights = dense_llama(cfg, dev, seed)
    stats["hqq_s"] = requantize(weights, lambda w: hqq_quantize(w, 4, 64, device=dev))
    weights = llama.fuse_projections(weights, cfg)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/llama-3.1-8b-hqq4.uqff"
        t0 = time.monotonic()
        save_uqff(path, cfg, weights)
        stats["write_s"] = time.monotonic() - t0
        stats["bytes"] = os.path.getsize(path)
        del weights
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        pipe = load_pipeline(path, device=dev)
        torch.cuda.synchronize()
        stats["read_s"] = time.monotonic() - t0
    check(pipe.cfg == cfg, f"phase 20: the file's config {pipe.cfg} is not {cfg}")
    return pipe.weights


def leaves_equal(a, b) -> bool:
    """Two weight trees hold the same leaves, bit for bit (FP8 codes as
    bytes)."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(leaves_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(leaves_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, Fp8Tensor):
        return (isinstance(b, Fp8Tensor) and a.block_shape == b.block_shape
                and torch.equal(a.data.view(torch.uint8), b.data.view(torch.uint8))
                and torch.equal(a.scale, b.scale))
    if isinstance(a, QTensor):
        return all(leaves_equal(getattr(a, f), getattr(b, f)) for f in ("data", "scale", "bias"))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def check_fp8_uqff(dev) -> dict:
    """Phase 21's 2-layer check: Llama-3.1-8B's projections in blockwise FP8
    written with ``save_uqff`` and read back with ``load_uqff``: every code,
    scale and dense leaf bit for bit; the file's weights through the kernels
    and the plain versions (``two_layer_runs``), the e4m3 form in both
    bodies. Returns the kernel run's launch counts."""
    cfg = ModelConfig(**dict(LLAMA31_8B, num_layers=2))
    weights = build_fp8(cfg, dev, SEED + 102)
    with tempfile.TemporaryDirectory() as tmp:
        save_uqff(f"{tmp}/fp8.uqff", cfg, weights)
        cfg2, back = load_uqff(f"{tmp}/fp8.uqff", device=dev)
    check(cfg2 == cfg and leaves_equal(weights, back),
          "phase 21: the FP8 uqff file does not give back its weights bit for bit")
    del weights
    what = "llama-3.1-8b fp8 uqff model"
    counts, note, _ = two_layer_runs(dev, cfg, back, SEED + 103, what, FP8_KERNELS)
    bodies = {b: counts.get(f"w8_matmul_e4m3.{b}", 0) for b in ("decode", "prefill")}
    check(all(bodies.values()), f"{what}: e4m3 bodies launched {bodies}")
    log(f"  {what} 2 layers (read back bit for bit): {note}")
    return counts


def write_hf_dir(path, cfg_json: dict, tensors: dict) -> None:
    path.mkdir()
    (path / "config.json").write_text(json.dumps(cfg_json))
    hf_loader.write_safetensors(path / "model.safetensors", tensors)


def nf4_tensors(sd: dict, dev) -> dict:
    """A bf16 checkpoint with every projection as bitsandbytes stores NF4
    with double-quantized scales (``quant/bnb.py``: codes and scales on the
    card; a 256-entry nested table; the offset under ``nested_offset``)."""
    nested = torch.linspace(-1.0, 1.0, 256, device=dev)
    table = torch.from_numpy(bnb.NF4_CODE).to(dev)
    out = {}
    for name, t in sd.items():
        if not name.endswith("_proj.weight"):
            out[name] = t
            continue
        packed, absmax = bnb.quantize_4bit(t)
        idx, na, off = bnb.double_quantize(absmax, nested)
        meta = {"quant_type": "nf4", "blocksize": 64, "dtype": "bfloat16",
                "shape": list(t.shape), "nested_blocksize": 256, "nested_offset": off}
        out.update({name: packed, name + ".absmax": idx, name + ".quant_map": table,
                    name + ".nested_absmax": na, name + ".nested_quant_map": nested,
                    name + ".quant_state.bitsandbytes__nf4": torch.tensor(
                        list(json.dumps(meta).encode()), dtype=torch.uint8)})
    return out


def check_format_models(dev) -> dict:
    """Phase 3p: 2 layers at full Llama-3.1-8B width, drawn as a bf16
    checkpoint on the card, written as HF directories and files to a
    temporary directory and loaded back through the port's entry points:

    * an NF4 directory (double-quantized scales): two projections' dense
      weights (layer 0's k, layer 1's v: 4.2 M weights each, so the CPU's
      decode stays small in host memory) decoded on the card bit-equal to
      the CPU's decode; loaded with
      ``isq=Q4_K``, and with ``isq=Q8_0`` under a ``Topology`` of Q2_K
      (layer 0) and Q3_K (layer 1);
    * the bf16 directory overlaid with a mistral.rs UQFF file of its
      projections at Q4_K (``save_reference_uqff``, ``from_uqff=``);
    * ``quantize`` (the CLI) of the bf16 directory to a Q4_K ``.gguf``,
      loaded by ``load_gguf_model``.

    Each through the kernels and the plain versions (``two_layer_runs``).
    Returns each run's kernel launch counts."""
    hf_json = dict(LLAMA31_8B_JSON, num_hidden_layers=2)
    cfg = config_from_hf(hf_json)
    sd = bf16_checkpoint(cfg, dev, SEED + 104)
    out, times = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.monotonic()
        write_hf_dir(tmp / "bf16", hf_json, sd)
        write_hf_dir(tmp / "nf4", dict(hf_json, quantization_config={
            "quant_method": "bitsandbytes", "load_in_4bit": True,
            "bnb_4bit_quant_type": "nf4", "bnb_4bit_use_double_quant": True}),
            nf4_tensors(sd, dev))
        save_reference_uqff(str(tmp / "q4k.uqff"),
                            {n: t for n, t in sd.items() if n.endswith("_proj.weight")},
                            GGMLType.Q4_K)
        times["write"] = time.monotonic() - t0
        del sd
        gc.collect()
        torch.cuda.empty_cache()
        stored = hf_loader.load_safetensors_dir(tmp / "nf4")
        for name in ("model.layers.0.self_attn.k_proj.weight",
                     "model.layers.1.self_attn.v_proj.weight"):
            card = bnb.decode_bnb_param(stored, name, dev).cpu()
            check(torch.equal(card, bnb.decode_bnb_param(stored, name, "cpu")),
                  f"phase 3p: {name}'s NF4 decode on the card differs from the CPU's")
        del stored
        topo = Topology.from_dict({"0-1": {"isq": "Q2K"}, "1-2": {"isq": "Q3K"}}, 2)
        loads = (
            ("nf4 isq q4k", lambda: hf_loader.load_hf_model(tmp / "nf4", device=dev,
                                                            isq=GGMLType.Q4_K)[1],
             ("w4_matmul", "w8_matmul")),
            ("nf4 topology q2k/q3k", lambda: hf_loader.load_hf_model(
                tmp / "nf4", device=dev, isq=GGMLType.Q8_0, topology=topo)[1],
             ("w4_matmul_g16", "w8_matmul")),
            ("bf16 + uqff q4k overlay", lambda: load_pipeline(
                str(tmp / "bf16"), device=dev, from_uqff=str(tmp / "q4k.uqff")).weights,
             ("w4_matmul",)),
            ("quantize q4k gguf", lambda: load_gguf_model(str(tmp / "q4k.gguf"),
                                                          device=dev)[1],
             ("w4_matmul", "w8_matmul")),
        )
        for i, (what, load, kernels) in enumerate(loads):
            if what.startswith("quantize"):
                t0 = time.monotonic()
                check(cli.main(["quantize", str(tmp / "bf16"), "--quant", "q4k", "-o",
                                str(tmp / "q4k.gguf"), "--device", dev.type]) == 0,
                      "phase 3p: quantize failed")
                times["quantize"] = time.monotonic() - t0
            t0 = time.monotonic()
            weights = llama.fuse_projections(load(), cfg)
            torch.cuda.synchronize()
            times[what] = time.monotonic() - t0
            if what.startswith("nf4 topology"):
                types = [weights["layers"][j]["wqkv"].ggml_type for j in range(2)]
                check(types == [GGMLType.Q2_K, GGMLType.Q3_K]
                      and weights["lm_head"].ggml_type == GGMLType.Q8_0,
                      f"phase 3p: topology types {types}, head {weights['lm_head'].ggml_type}")
            full = f"llama-3.1-8b {what} model"
            counts, note, _ = two_layer_runs(dev, cfg, weights, SEED + 105 + i, full,
                                             kernels + ("paged_decode", "paged_prefill"))
            log(f"  {full} 2 layers: {note}")
            out[what] = counts
            del weights
            gc.collect()
            torch.cuda.empty_cache()
    log("  phase 3p seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in times.items())
        + f" (files written and read in a temporary directory); {host_rss()}")
    return out


# ---------------------------------------------------------------------------
# phases 4 to 16: serve
# ---------------------------------------------------------------------------


class ByteTokenizer:
    """UTF-8 bytes as token ids, with the port's tokenizer interface."""

    def encode(self, text, add_bos=None):
        return list(text.encode("utf-8"))

    def decode(self, ids, skip_special_tokens=True):
        return bytes(i for i in ids if i < 256).decode("utf-8", errors="replace")

    def detokenizer(self):
        return Detokenizer(self)


def traced_ms(fn):
    """``fn()``'s wall time on the host clock (it ends in a host sync) and
    the device's kernel time in a ``torch.profiler`` trace of a later call:
    ``(wall ms, device ms, {kernel name: device µs})``. A trace now and then
    loses records, which only lowers its sum: the largest of 3 traces."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.monotonic()
    fn()
    wall = (time.monotonic() - t0) * 1e3
    best: dict = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        by_kernel = {k: us for k, (us, _) in device_kernels(prof).items()}
        if sum(by_kernel.values()) > sum(best.values()):
            best = by_kernel
    return wall, sum(best.values()) / 1e3, best


def step_line(what: str, wall: float, busy: float) -> str:
    if busy == 0:
        return f"{what} {wall:.2f} ms wall; device time not measured"
    return (f"{what} {wall:.2f} ms wall, device kernels {busy:.3f} ms, device idle "
            f"{100 * (1 - busy / wall):.1f} %")


class StepState:
    """The device state a decode step changes (the KV pools and, for 1-byte
    pools, their scale planes; the sampling state) saved once, so that
    several runs start from the same state."""

    def __init__(self, engine):
        cache = engine.cache  # PagedKVCache or DeepSeek's LatentCache
        self.live = [t for t in vars(cache).values() if isinstance(t, torch.Tensor)]
        self.live += [getattr(engine.samp_state, k) for k in engine.samp_state._ROWS]
        self.saved = [t.clone() for t in self.live]

    def restore(self) -> None:
        for t, s in zip(self.live, self.saved):
            t.copy_(s)
        torch.cuda.synchronize()


def graph_step_checks(engine, add_request, name_line: str) -> str:
    """On the serve run's engine (its server stopped), 6 running requests of
    100-token prompts, 3 greedy and 3 seeded sampled, past their first
    decode step (so the width's graph is captured):

    * from one saved state, 8 decode steps through the step function run
      eagerly and 8 through the graph: the logits must be bit-equal and the
      greedy and sampled tokens identical;
    * the first replay with its staging runs under
      ``torch.cuda.set_sync_debug_mode("error")``, up to the one result
      wait;
    * the step's wall time (host clock, to the result wait), the device's
      kernel time (``torch.profiler``) and so its idle share, through the
      graph and eagerly, from the same state; then one engine step (the
      scheduler, the staging, the replay and the commits) timed and traced,
      with the kernels that took most of the device time."""
    seqs = [add_request([(7 * i + j) % 250 + 1 for j in range(100)],
                        SamplingParams(temperature=0.0, max_tokens=40) if i % 2 == 0 else
                        SamplingParams(temperature=0.8, top_p=0.95, top_k=40, seed=100 + i,
                                       max_tokens=40)) for i in range(6)]
    while any(len(s.generated_ids) < 2 for s in seqs):  # prefills and a first decode step
        engine.step()
    ds, width, bs = engine.decode_step, engine._max_blocks_bucket(), engine.block_size
    check(width in ds._graphs, f"decode step: no graph captured at width {width}")
    saved = StepState(engine)
    rows = {s.slot: (s.all_ids[-1], s.total_len - 1, engine.kv.block_table(s.request_id))
            for s in seqs}

    def stage(i, toks):
        a = ds.staging(width)
        for slot, (_, pos0, table) in rows.items():
            pos = pos0 + i
            check(pos < bs * len(table), "decode step: position past the sequence's blocks")
            a[slot, :4] = (toks[slot], pos, table[pos // bs] * bs + pos % bs, pos + 1)
            a[slot, 4:4 + len(table)] = table

    runs = {}
    for mode in ("eager", "graph"):
        saved.restore()
        toks = {slot: r[0] for slot, r in rows.items()}
        logits, tokens = [], []
        for i in range(8):
            stage(i, toks)
            if mode == "eager":
                ds.upload(width)
                out = ds.compute(width)
                got = out.tokens.cpu().numpy()
            else:
                if i == 0:
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        ds.launch(width)
                    finally:
                        torch.cuda.set_sync_debug_mode(0)
                else:
                    ds.launch(width)
                got = ds.wait()[0]
                out = ds.graph_output(width)
            logits.append(out.logits.clone())
            tokens.append([int(got[slot]) for slot in sorted(rows)])
            toks = {slot: int(got[slot]) for slot in rows}
        runs[mode] = (logits, tokens)
    for i, (a, b) in enumerate(zip(runs["eager"][0], runs["graph"][0])):
        if not torch.equal(a, b):
            raise AssertionError(f"decode step {i}: graph logits differ from the eager step's "
                                 f"by {(a - b).abs().max().item()}")
    if runs["eager"][1] != runs["graph"][1]:
        raise AssertionError(f"decode step: graph tokens {runs['graph'][1]} != eager "
                             f"{runs['eager'][1]}")
    n_sampled = sum(1 for s in seqs if not s.params.is_greedy)
    lines = [f"graph vs eager step function, 8 steps from one state: logits bit-equal, "
             f"tokens identical ({6 - n_sampled} greedy, {n_sampled} seeded sampled rows); "
             f"one replay and its staging under sync debug mode 'error': no host sync"]

    def graph_step():
        stage(0, {slot: r[0] for slot, r in rows.items()})
        ds.launch(width)
        ds.wait()

    def eager_step():
        stage(0, {slot: r[0] for slot, r in rows.items()})
        ds.upload(width)
        for t in ds.compute(width)[:4]:
            t.cpu()

    for name, fn in (("graph", graph_step), ("eager", eager_step)):
        saved.restore()
        fn()  # the state after one step: every later call repeats the same work
        walls = []
        for _ in range(5):
            t0 = time.monotonic()
            fn()
            walls.append((time.monotonic() - t0) * 1e3)
        _, busy, _ = traced_ms(fn)
        lines.append(step_line(f"{name} step function (6 rows), median of 5",
                               statistics.median(walls), busy))
    saved.restore()
    del saved
    wall, busy, by_kernel = traced_ms(engine.step)
    engine.run_to_completion()
    if busy == 0:
        return "; ".join(lines + [step_line("engine step (graph)", wall, busy)])
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    tops = ", ".join(f"{k[:48]} {v / 1e3:.3f} ms" for k, v in top)
    # the decode body (mm_decode_kernel<format, row tiles of 8, ..>) runs the
    # dense projections of <= 8 rows with its 8-row tile and the grouped
    # experts with its 16-row tile, W4 in format 0 and W8 in formats 1 and 2
    # (W8's e4m3 form, FP8 weights, format 3);
    # dense grouped, paged decode and MLA decode are named as in this tree
    # and its parents (MLA: one kernel, or a split and a combine kernel)
    families = {"W4": ("mm_decode_kernel<0, 1",), "W4 grouped": ("mm_decode_kernel<0, 2",),
                "W8": ("mm_decode_kernel<1, 1", "mm_decode_kernel<2, 1"),
                "W8 e4m3": ("mm_decode_kernel<3, 1",),
                "W8 grouped": ("mm_decode_kernel<1, 2", "mm_decode_kernel<2, 2"),
                "W8 prefill": ("w8_prefill_kernel",),
                "dense grouped": ("dense_g_decode_kernel", "dense_g_prefill_kernel",
                                  "dense_grouped_kernel"),
                "paged decode": ("split_decode_kernel", "paged_decode_kernel"),
                "MLA decode": ("mla_decode_kernel", "mla_decode_split_kernel",
                               "mla_decode_combine_kernel")}
    # of the others: the dense bf16 products (cuBLAS, whose kernels are
    # named nvjet_*, *gemm* or cutlass*) and PyTorch's own elementwise and
    # reduction kernels (norms, RoPE, activations, casts, residual adds)
    others = {"cuBLAS": ("nvjet", "gemm", "cutlass"),
              "PyTorch elementwise/reduce": ("elementwise_kernel", "reduce_kernel")}
    fam_ms = {f: sum(v for k, v in by_kernel.items() if any(c in k for c in keys)) / 1e3
              for f, keys in {**families, **others}.items()}
    fam = ", ".join(f"{f} {v:.3f} ms" for f, v in fam_ms.items())
    ours = sum(fam_ms[f] for f in families)
    lines.append(f"{step_line('engine step (graph, 6 rows)', wall, busy)} "
                 f"({len(by_kernel)} kernel names; the port's kernels {ours:.3f} ms, all "
                 f"others {busy - ours:.3f} ms); {fam}; top: {tops}")
    return "\n  ".join(lines) + f" [{name_line}]"


def serve(dev, name_line: str, cfg, build, seed: int, model_id: str,
          required, adapter_cls=None, quant=None, **serve_kw) -> tuple:
    """Serve 6 concurrent requests on ``build(cfg, dev, seed)``'s weights
    (through ``adapter_cls``'s arch adapter when given) and, with ``quant``
    = ``(kv_quant, required, max_tokens)``, a second time on the same
    weights from 1-byte KV pools; returns the launch counts of each run
    (None for a run not asked for), which must show every kernel of its
    ``required`` and no plain version. ``serve_kw`` goes to
    :func:`serve_once`."""
    t_w = time.monotonic()
    weights = build(cfg, dev, seed)
    torch.cuda.synchronize()
    log(f"  {cfg.num_layers}-layer weights drawn on the device in "
        f"{time.monotonic() - t_w:.1f} s "
        f"({torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB allocated)")
    counts = serve_once(dev, name_line, cfg, weights, model_id, required, adapter_cls,
                        **serve_kw)
    q_counts = None
    if quant is not None:
        kv_quant, q_required, q_tokens = quant
        log(f"  the same weights served again from {kv_quant} KV pools")
        q_counts = serve_once(dev, name_line, cfg, weights, f"{model_id}-{kv_quant}-kv",
                              q_required, adapter_cls, kv_quant, q_tokens, **serve_kw)
    del weights
    gc.collect()
    torch.cuda.empty_cache()
    return counts, q_counts


def serve_once(dev, name_line: str, cfg, weights, model_id: str, required, adapter_cls=None,
               kv_quant=None, max_tokens: int = 24, num_blocks: int = 8 * 16,
               max_model_len: int = 1024, sizes=(40, 97, 180, 290, 430, 600)) -> dict:
    """One serve run of ``serve`` (``kv_quant``: its KV pools; ``num_blocks``
    KV blocks of 64 positions), requests of ``sizes`` prompt tokens,
    each ``max_tokens`` tokens long, then the graph checks on its engine."""
    adapter = adapter_cls(cfg, weights, device=dev) if adapter_cls else None
    engine = Engine(cfg, weights, num_blocks=num_blocks, block_size=64, max_batch=8,
                    max_model_len=max_model_len, prefill_chunk=256, device=dev, seed=SEED,
                    adapter=adapter, kv_quant=kv_quant)
    log(f"  split state reserved for the graphs: "
        f"{_cuda.split_workspace(dev, 1).numel() * 4 / 2**20:.1f} MiB of workspace, "
        f"{_cuda.split_counters(dev, 1).numel()} counters")
    seqs = []
    add_request = engine.add_request

    def recording_add_request(*a, **kw):
        seq = add_request(*a, **kw)
        seqs.append(seq)
        return seq

    engine.add_request = recording_add_request
    tok = ByteTokenizer()
    # the prompt is the message text itself, so its length in bytes is its
    # length in tokens
    template = resolve_chat_template(
        override="{% for message in messages %}{{ message['content'] }}{% endfor %}")
    threads_before = set(threading.enumerate())
    server = Server(engine, tok, template, model_id, host="127.0.0.1", port=0)
    server.start()
    # prompts of 40 to 600 tokens (three longer than one prefill chunk), or
    # the caller's
    bodies = []
    for i, n in enumerate(sizes):
        content = ("the quick brown fox jumps over the lazy dog " * (n // 44 + 1))[:n]
        body = {"model": model_id,
                "messages": [{"role": "user", "content": content}], "max_tokens": max_tokens}
        if i % 2 == 0:
            body["temperature"] = 0.0
        else:
            body.update(temperature=0.8, top_p=0.95, top_k=40, seed=100 + i)
        if i == 3:
            body["stream"] = True
        bodies.append(body)
    expected_prompt = [len(tok.encode(template.render(b["messages"], add_generation_prompt=True)))
                       for b in bodies]
    results: list = [None] * len(bodies)
    errors: list = []

    def send(i):
        req = urllib.request.Request(
            server.url + "/v1/chat/completions", data=json.dumps(bodies[i]).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                results[i] = (r.status, r.read().decode())
        except Exception as e:  # noqa: BLE001 — reported and re-raised below
            errors.append(f"request {i}: {type(e).__name__}: {e}")

    with urllib.request.urlopen(server.url + "/health", timeout=30) as r:
        check(json.loads(r.read()) == {"status": "ok"}, "serve: /health")
    _cuda.reset_counts()
    t_s = time.monotonic()
    clients = [threading.Thread(target=send, args=(i,)) for i in range(len(bodies))]
    for c in clients:
        c.start()
    for c in clients:
        c.join(300)
    wall = time.monotonic() - t_s
    counts = dict(_cuda.COUNTS)
    server.shutdown()
    for th in threading.enumerate():
        if th not in threads_before:
            th.join(10)
    leftover = [th.name for th in threading.enumerate()
                if th not in threads_before and th.is_alive()]
    if errors or any(c.is_alive() for c in clients):
        raise AssertionError(f"serve: requests failed: {errors}")
    if leftover:
        raise AssertionError(f"serve: threads still running after shutdown: {leftover}")
    for i, (status, text) in enumerate(results):
        if status != 200:
            raise AssertionError(f"request {i}: HTTP {status}")
        if bodies[i].get("stream"):
            events = [ln[6:] for ln in text.splitlines() if ln.startswith("data: ")]
            check(events[-1] == "[DONE]", f"request {i}: stream ends {events[-3:]}")
            finish = json.loads(events[-2])["choices"][0]["finish_reason"]
        else:
            body = json.loads(text)
            usage = body["usage"]
            check(usage == {"prompt_tokens": expected_prompt[i],
                            "completion_tokens": max_tokens,
                            "total_tokens": expected_prompt[i] + max_tokens},
                  f"request {i}: usage {usage}, prompt {expected_prompt[i]} tokens")
            finish = body["choices"][0]["finish_reason"]
        check(finish == "length", f"request {i}: finish_reason {finish!r}")
    for seq in seqs:
        check(len(seq.generated_ids) == max_tokens,
              f"{seq.request_id}: {len(seq.generated_ids)} tokens, not {max_tokens}")
    missing = [k for k in required if counts.get(k, 0) == 0]
    plain = {k: v for k, v in counts.items() if k.endswith("_plain") and v}
    if missing or plain:
        raise AssertionError(f"serve: kernels not launched {missing}, plain versions run {plain}")
    ttft = sorted(s.first_token_time - s.arrival_time for s in seqs)
    st = engine.stats
    dec_tokens = st["generated_tokens"] - len(seqs)
    dec_tps = dec_tokens / st["decode_time_s"]
    cap = engine.decode_step.capture_seconds
    log(f"  served {len(seqs)} requests, prompts {sorted(expected_prompt)} tokens, "
        f"{max_tokens} tokens each, in {wall:.2f} s; TTFT median {statistics.median(ttft):.3f} s, max "
        f"{ttft[-1]:.3f} s; decode {dec_tps:.1f} tok/s over {st['decode_steps']} steps "
        f"({st['decode_time_s'] / st['decode_steps'] * 1e3:.1f} ms/step; of it "
        f"{cap:.3f} s warming up and capturing {len(engine.decode_step._graphs)} graph(s), "
        f"without which {dec_tokens / (st['decode_time_s'] - cap):.1f} tok/s), "
        f"{st['prefill_steps']} prefill steps ({st['prefill_time_s']:.2f} s) "
        f"[{name_line}]")
    log(f"  kernel launches in the serve run: {counts}")
    log(f"  {graph_step_checks(engine, add_request, name_line)}")
    # the recording wrapper on the engine refers back to it: drop it, so that
    # the KV pools are freed before the next run
    del engine.add_request
    del engine, server, adapter
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 19: the calibration loop (imatrix, ISQ, perplexity, generate, embed)
# ---------------------------------------------------------------------------

# the W4 and W8 kernels' names in a trace (decode body: format 0 is W4, 1
# and 2 are W8; the prefill bodies and W8's split sum)
W4_TRACE = ("w4_prefill_kernel", "mm_decode_kernel<0")
W8_TRACE = ("w8_prefill_kernel", "w8_split_sum_kernel", "mm_decode_kernel<1",
            "mm_decode_kernel<2", "mm_decode_kernel<3")


def calibration_loop(dev, name_line: str) -> dict:
    """Phase 19 on the 32-layer Llama-3.1-8B geometry drawn as a bf16
    checkpoint as phase 16 draws it (:func:`bf16_checkpoint`):

    * ``ImatrixCollector`` over 4 drawn batches of 1 x 512 tokens, in f32
      over an f32 copy of the weights (freed before the next step);
    * ISQ to Q4_K without and with that imatrix (at least one block's codes
      must differ: the rows reached the quantizer);
    * ``compute_perplexity`` (window 512, batch 4, 8 windows of drawn
      tokens) of the bf16 model, the Q4_K and the Q4_K+imatrix models, each
      finite (drawn weights and tokens give the values no meaning); one
      batch of the Q4_K model through the kernels against the plain
      versions: logits within 5e-2 of the largest (phase 3's tolerance),
      and the two runs' mean NLL;
    * one traced batch of 4 windows: wall, device ms, idle share, the W4
      and W8 kernels' device ms and launches;
    * ``generate``: 32 greedy tokens after a 128-token prompt, ms per
      token, and one eager decode step's wall against its device time;
    * ``embed`` of 8 prompts (finite, unit norm).

    Stays under 600 s. Returns the launch counts of the Q4_K perplexity
    run."""
    t_phase = time.monotonic()
    cfg = ModelConfig(**LLAMA31_8B)
    gen = torch.Generator(device=dev).manual_seed(SEED + 98)
    sd = bf16_checkpoint(cfg, dev, SEED + 99)
    toks = torch.randint(0, cfg.vocab_size, (8 * 512,), generator=gen, device=dev)
    calib = torch.randint(0, cfg.vocab_size, (4, 1, 512), generator=gen, device=dev)
    # the importance matrix, in f32
    t0 = time.monotonic()
    w32 = hf_loader.weights_from_state_dict(sd, cfg, dtype=torch.float32, device=dev)
    coll = ImatrixCollector(cfg, device=dev)
    for batch in calib:
        coll.update(w32, batch.cpu().numpy())
    im = coll.finalize()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    del w32
    gc.collect()
    torch.cuda.empty_cache()
    check(sorted(im) == ["attn_in", "down_in", "mlp_in", "o_in"]
          and all(np.isfinite(v).all() and v.shape[0] == 32 for v in im.values()),
          "phase 19: imatrix taps")
    log(f"  imatrix over {coll.tokens} tokens in f32: {time.monotonic() - t0:.2f} s, peak device "
        f"memory {peak:.2f} GiB; taps " + ", ".join(f"{k} {tuple(v.shape)}" for k, v in im.items()))
    with tempfile.TemporaryDirectory() as tmp:
        save_imatrix(f"{tmp}/imatrix.npz", im)
        back = load_imatrix(f"{tmp}/imatrix.npz")
    check(all(np.array_equal(back[k], v) for k, v in im.items()),
          "phase 19: the written imatrix reads back")
    ids = toks.tolist()
    ppl = {}
    t0 = time.monotonic()
    bf16 = hf_loader.weights_from_state_dict(sd, cfg, device=dev)
    ppl["bf16"] = compute_perplexity(bf16, cfg, ids, window=512, batch_size=4, device=dev)
    del bf16
    log(f"  perplexity bf16: {ppl['bf16']} in {time.monotonic() - t0:.2f} s")
    # ISQ without and with the imatrix
    quant = {}
    for label, rows in (("q4k", None), ("q4k+imatrix", im)):
        t0 = time.monotonic()
        quant[label] = hf_loader.weights_from_state_dict(sd, cfg, device=dev, isq=GGMLType.Q4_K,
                                                         imatrix=rows)
        torch.cuda.synchronize()
        log(f"  ISQ to Q4_K{' with the imatrix' if rows else ''}: "
            f"{time.monotonic() - t0:.2f} s")
    del sd
    gc.collect()
    torch.cuda.empty_cache()
    a, b = (quant[k]["layers"][0]["wq"] for k in ("q4k", "q4k+imatrix"))
    differ = (a.data != b.data).any(dim=0).sum().item()
    check(differ > 0, "phase 19: the imatrix changed no code of layer 0's wq")
    log(f"  layer 0 wq: {differ} of {a.data.shape[1]} rows have codes that the imatrix changed")
    for label in quant:
        quant[label] = llama.fuse_projections(quant[label], cfg)
    torch.cuda.empty_cache()
    weights = quant["q4k"]
    counts = {}
    for label, w in quant.items():
        t0 = time.monotonic()
        _cuda.reset_counts()
        ppl[label] = compute_perplexity(w, cfg, ids, window=512, batch_size=4, device=dev)
        torch.cuda.synchronize()
        if label == "q4k":
            counts = dict(_cuda.COUNTS)
        log(f"  perplexity {label}: {ppl[label]} in {time.monotonic() - t0:.2f} s")
    for label, r in ppl.items():
        check(math.isfinite(r["ppl"]) and r["windows"] == 8 and r["tokens_scored"] == 8 * 256,
              f"phase 19: perplexity {label} {r}")
    plain_run = {k: v for k, v in counts.items() if k.endswith("_plain") and v}
    check(counts.get("w4_matmul", 0) > 0 and counts.get("w8_matmul", 0) > 0 and not plain_run,
          f"phase 19: perplexity launches {counts}")
    del quant["q4k+imatrix"]
    torch.cuda.empty_cache()
    # one batch of 4 windows through the kernels and through the plain versions
    batch = toks.reshape(8, 512)[:4]
    pos = torch.arange(512, device=dev)[None].expand(4, 512)
    logits = {}
    for plain in (False, True):
        cache = llama.KVCache.create(cfg, 4, 512, device=dev)
        out, _ = llama.forward(weights, cfg, batch, pos, cache, [0] * 4, plain=plain)
        nll = -torch.log_softmax(out[:, :-1], dim=-1).gather(-1, batch[:, 1:, None]).mean()
        logits[plain] = (out, nll.item())
        del cache
    err = (logits[False][0] - logits[True][0]).abs().max().item()
    scale = logits[True][0].abs().max().item()
    check(bool(torch.isfinite(logits[False][0]).all()) and err <= 5e-2 * scale,
          f"phase 19: Q4_K logits through the kernels differ from the plain run's by {err} > "
          f"{5e-2 * scale}")
    log(f"  Q4_K batch of 4 x 512, kernels vs plain: worst |err|/max|logit| "
        f"{err / scale:.3e} (tol 5e-2); mean NLL {logits[False][1]:.6f} vs {logits[True][1]:.6f}")
    del logits, out
    torch.cuda.empty_cache()
    # one traced batch of 4 windows
    cache = llama.KVCache.create(cfg, 4, 512, device=dev)

    def window():
        perplexity._window_nll(weights, cfg, cache, batch, 256, torch.bfloat16, False)[0].cpu()

    _cuda.reset_counts()
    window()
    per_batch = {k: v for k, v in _cuda.COUNTS.items() if v}
    wall, busy, by_kernel = traced_ms(window)
    w4 = sum(v for k, v in by_kernel.items() if any(n in k for n in W4_TRACE)) / 1e3
    w8 = sum(v for k, v in by_kernel.items() if any(n in k for n in W8_TRACE)) / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5]
    log(f"  {step_line('perplexity batch (4 windows of 512)', wall, busy)}; W4 {w4:.3f} ms, W8 "
        f"{w8:.3f} ms, all others {busy - w4 - w8:.3f} ms; launches a batch {per_batch}; top: "
        + ", ".join(f"{k[:48]} {v / 1e3:.3f} ms" for k, v in top) + f" [{name_line}]")
    del cache
    torch.cuda.empty_cache()
    # generate: 32 greedy tokens after a 128-token prompt
    prompt = toks[:128].tolist()
    walls = {}
    for n in (1, 32):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out_toks = generate(weights, cfg, prompt, max_new_tokens=n, stop_tokens=set(), device=dev)
        walls[n] = (time.monotonic() - t0) * 1e3
        check(len(out_toks) == n, f"phase 19: generate gave {len(out_toks)} tokens, not {n}")
    cache = llama.KVCache.create(cfg, 1, 160, device=dev)
    llama.forward(weights, cfg, toks[None, :128], torch.arange(128, device=dev)[None], cache,
                  [0], logits_last_only=True)
    tok = toks[None, 128:129]
    p128 = torch.full((1, 1), 128, device=dev)

    def step():  # one eager decode step at position 128 (rewrites the same slot)
        llama.forward(weights, cfg, tok, p128, cache, [128], logits_last_only=True)[0].cpu()

    step()
    s_wall, s_busy, _ = traced_ms(step)
    per_token = (walls[32] - walls[1]) / 31
    log(f"  generate: 32 greedy tokens after 128 in {walls[32]:.1f} ms ({per_token:.2f} ms a token "
        f"after the first, {walls[1]:.1f} ms to the first); "
        f"{step_line('eager decode step', s_wall, s_busy)} [{name_line}]")
    del cache
    # embed 8 prompts
    prompts = [toks[i * 64:i * 64 + 16 + 6 * i].tolist() for i in range(8)]
    emb = embeddings.embed(weights, cfg, prompts, device=dev)
    check(emb.shape == (8, cfg.hidden_size) and np.isfinite(emb).all()
          and np.allclose(np.linalg.norm(emb, axis=-1), 1.0, atol=1e-3),
          f"phase 19: embed gave {emb.shape}")
    del weights, quant
    gc.collect()
    torch.cuda.empty_cache()
    dt = time.monotonic() - t_phase
    log("  perplexity (drawn weights and tokens: the values mean nothing): "
        + ", ".join(f"{k} {v['ppl']:.4f}" for k, v in ppl.items())
        + f"; phase 19 took {dt:.1f} s (limit 600)")
    check(dt < 600, f"phase 19 took {dt:.1f} s, over 600")
    return counts


# ---------------------------------------------------------------------------
# phase 22: constrained decoding, DRY, the text routes, a second model
# ---------------------------------------------------------------------------


class VocabTokenizer:
    """A tokenizer of Llama-3's 128256 ids with the port's interface: ids
    0-255 are single bytes (prompts encode as bytes, as with
    :class:`ByteTokenizer`), ids 256-127999 decode to byte strings of 1-12
    bytes drawn from ``seed`` (printable ASCII, one character in 20 a whole
    two- or three-byte UTF-8 character), and ids 128000-128255 are special
    tokens (``<|eot_id|>`` = 128009, the EOS) that decode to nothing unless
    asked to."""

    EOS = 128009
    WIDE = [c.encode() for c in "éüßñ€→日本語ÆøΩ"]

    def __init__(self, seed: int, size: int = 128256):
        rng = np.random.default_rng(seed)
        pieces = [bytes([i]) for i in range(256)]
        lengths = rng.integers(1, 13, 128000 - 256)
        for n in lengths.tolist():
            out = b""
            while len(out) < n:
                wide = self.WIDE[rng.integers(len(self.WIDE))]
                if rng.random() < 0.05 and len(out) + len(wide) <= n:
                    out += wide
                else:
                    out += bytes([int(rng.integers(32, 127))])
            pieces.append(out)
        self.special = {i: (b"<|eot_id|>" if i == self.EOS else f"<|reserved_{i}|>".encode())
                        for i in range(128000, size)}
        self.pieces = pieces

    def encode(self, text, add_bos=None):
        return list(text.encode("utf-8"))

    def decode(self, ids, skip_special_tokens=True):
        out = b"".join(self.pieces[i] if i < 128000 else
                       (b"" if skip_special_tokens else self.special[i]) for i in ids)
        return out.decode("utf-8", errors="replace")

    def detokenizer(self):
        return Detokenizer(self)


LARK_LIST = """start: "[" item ("," item)* "]"
item: NUM | WORD | start
NUM: /[0-9]{1,4}/
WORD: /[a-z]{2,8}/
"""
REGEX_EMAIL = r"[a-z]{3,8}@(example|test)\.(com|org)"
CHOICES = ["positive", "negative", "neutral"]
PERSON_SCHEMA = {"type": "object", "properties": {"name": {"type": "string"},
                                                  "age": {"type": "integer"}}}


def recognizer(kind: str):
    """A fresh recognizer of a phase-22 request kind."""
    from mistralrs_tpu_torch.cfg_grammar import LarkConstraint
    from mistralrs_tpu_torch.grammar import ChoiceConstraint, JsonConstraint, RegexConstraint

    return {"json": lambda: JsonConstraint("object"),
            "regex": lambda: RegexConstraint(REGEX_EMAIL),
            "choice": lambda: ChoiceConstraint(CHOICES),
            "lark": lambda: LarkConstraint(LARK_LIST)}[kind]()


def http(url: str, path: str, body=None, method=None, timeout: float = 300):
    """``(status, parsed JSON or text)`` of one request; an HTTP error's
    status and body are returned, not raised."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, raw = r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        status, raw = e.code, e.read().decode()
    try:
        return status, json.loads(raw)
    except json.JSONDecodeError:
        return status, raw


def concurrently(calls: dict) -> dict:
    """Run ``{name: fn}`` on threads at once → ``{name: result}``; a call's
    exception fails the phase."""
    out, errors = {}, []

    def run(name, fn):
        try:
            out[name] = fn()
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(f"{name}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=run, args=kv) for kv in calls.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"requests failed: {errors}")
    return out


def write_tiny_llama_gguf(path, seed: int) -> None:
    """A 2-layer Llama-geometry GGUF (hidden 512, 4 heads of 128 on 2 KV
    heads, FFN 1024, Q4_K projections and embedding, a Q6_K head) with a
    byte-level BPE tokenizer of the 256 byte symbols, 3 special tokens and
    61 unused ones (vocab 320), and a ChatML template."""
    from mistralrs_tpu_torch.gguf.writer import GGUFWriter

    byte_syms = [chr(c) for c in range(33, 127)] + [chr(c) for c in range(161, 173)] + \
        [chr(c) for c in range(174, 256)]
    extra = [chr(256 + i) for i in range(256 - len(byte_syms))]
    tokens = byte_syms + extra + ["<|endoftext|>", "<|im_start|>", "<|im_end|>"]
    tokens += [f"<|unused_{i}|>" for i in range(320 - len(tokens))]
    types = [1] * 256 + [3] * (len(tokens) - 256)
    h, inter, v = 512, 1024, len(tokens)
    gen = torch.Generator().manual_seed(seed)
    w = GGUFWriter(path)
    w.add_metadata("general.architecture", "llama")
    for key, val in dict(block_count=2, context_length=1024, embedding_length=h,
                         feed_forward_length=inter, vocab_size=v,
                         **{"attention.head_count": 4, "attention.head_count_kv": 2,
                            "rope.dimension_count": 128}).items():
        w.add_metadata(f"llama.{key}", np.uint32(val))
    w.add_metadata("llama.attention.layer_norm_rms_epsilon", np.float32(1e-5))
    w.add_metadata("llama.rope.freq_base", np.float32(5e5))
    w.add_metadata("tokenizer.ggml.model", "gpt2")
    w.add_metadata("tokenizer.ggml.tokens", tokens)
    w.add_metadata("tokenizer.ggml.merges", [])
    w.add_metadata("tokenizer.ggml.token_type", types)
    w.add_metadata("tokenizer.ggml.eos_token_id", np.uint32(tokens.index("<|im_end|>")))
    w.add_metadata("tokenizer.ggml.bos_token_id", np.uint32(tokens.index("<|endoftext|>")))
    w.add_metadata("tokenizer.ggml.add_bos_token", False)
    w.add_metadata("tokenizer.chat_template",
                   "{% for message in messages %}{{'<|im_start|>' + message['role'] + '\\n' + "
                   "message['content'] + '<|im_end|>' + '\\n'}}{% endfor %}"
                   "{% if add_generation_prompt %}{{ '<|im_start|>assistant\\n' }}{% endif %}")

    def quant(name, shape, t, std=0.05):  # blocks drawn as they are stored
        w.add_raw_tensor(name, draw_blocks(t, shape, gen, "cpu", std=std), shape, t)

    quant("token_embd.weight", (v, h), GGMLType.Q4_K, std=0.5)
    w.add_tensor("output_norm.weight", torch.ones(h))
    quant("output.weight", (v, h), GGMLType.Q6_K)
    for i in range(2):
        p = f"blk.{i}."
        w.add_tensor(p + "attn_norm.weight", torch.ones(h))
        w.add_tensor(p + "ffn_norm.weight", torch.ones(h))
        for name, shape in (("attn_q", (h, h)), ("attn_k", (256, h)), ("attn_v", (256, h)),
                            ("attn_output", (h, h)), ("ffn_gate", (inter, h)),
                            ("ffn_up", (inter, h)), ("ffn_down", (h, inter))):
            quant(p + name + ".weight", shape, GGMLType.Q4_K)
    w.write()


class _BiasedRows:
    """Phase 22's host loop over the constrained rows of a saved decode
    state: each row's recognizer state, advanced by the tokens a step gives
    and written as the next mask (or zeros once complete or dead) with
    ``DecodeStep.set_bias_row``, as ``Engine._commit_token`` does."""

    def __init__(self, engine, rows: dict):
        self.engine, self.rows = engine, dict(rows)  # slot -> (recognizer, state)
        self.builder = engine._get_mask_builder()

    def commit(self, tokens: dict) -> None:
        for slot, (cons, st) in list(self.rows.items()):
            if st is None:
                continue
            st = self.builder.advance_with_token(cons, st, tokens[slot])
            if st is None or cons.is_complete(st):
                self.rows[slot] = (cons, None)
                self.engine.decode_step.set_bias_row(slot, None)
            else:
                self.rows[slot] = (cons, st)
                allow = self.builder.mask(cons, st, self.engine.cfg.eos_token_ids)
                self.engine.decode_step.set_bias_row(
                    slot, np.where(allow, 0.0, -1e30).astype(np.float32))


def constrained_step_checks(engine, n_constrained: int, name_line: str) -> str:
    """8 running requests on the served engine (its server stopped), the
    first ``n_constrained`` JSON-constrained, greedy and seeded sampled
    rows alternating, past their first decode step: from one saved state
    (KV pools and sampling state, ``constraint_bias`` included) 8 decode
    steps through the step function eagerly and 8 through the graph, each
    followed by the host's mask update, must give bit-equal logits and the
    same tokens; then one engine step's wall time (host clock), and the
    device's kernel time in a trace of the next step, so its idle share."""
    seqs = []
    for i in range(8):
        p = SamplingParams(temperature=0.0, max_tokens=200) if i % 2 == 0 else \
            SamplingParams(temperature=0.8, top_p=0.95, seed=300 + i, max_tokens=200)
        if i < n_constrained:
            p.constraint = "json_object"
        seqs.append(engine.add_request([(11 * i + j) % 200 + 32 for j in range(90)], p))
    while any(len(s.generated_ids) < 2 and not s.is_finished for s in seqs):
        engine.step()
    live = [s for s in seqs if not s.is_finished]
    ds, width, bs = engine.decode_step, engine._max_blocks_bucket(), engine.block_size
    check(width in ds._graphs, f"phase 22: no graph captured at width {width}")
    saved = StepState(engine)
    start = {s.slot: (s.all_ids[-1], s.total_len - 1, engine.kv.block_table(s.request_id))
             for s in live}
    # a row whose output completed its JSON object has stopped: fewer rows
    cons0 = {s.slot: (s.constraint, s.constraint_state) for s in live
             if s.constraint is not None}
    runs = {}
    for mode in ("eager", "graph"):
        saved.restore()
        host = _BiasedRows(engine, cons0)
        toks = {slot: r[0] for slot, r in start.items()}
        logits, tokens = [], []
        for i in range(8):
            a = ds.staging(width)
            for slot, (_, pos0, table) in start.items():
                pos = pos0 + i
                a[slot, :4] = (toks[slot], pos, table[pos // bs] * bs + pos % bs, pos + 1)
                a[slot, 4:4 + len(table)] = table
            if mode == "eager":
                ds.upload(width)
                out = ds.compute(width)
                got = out.tokens.cpu().numpy()
            else:
                ds.launch(width)
                got = ds.wait()[0]
                out = ds.graph_output(width)
            logits.append(out.logits.clone())
            toks = {slot: int(got[slot]) for slot in start}
            tokens.append([toks[slot] for slot in sorted(start)])
            host.commit(toks)
        runs[mode] = (logits, tokens)
    for i, (a, b) in enumerate(zip(runs["eager"][0], runs["graph"][0])):
        if not torch.equal(a, b):
            raise AssertionError(f"phase 22, {n_constrained} constrained rows, step {i}: graph "
                                 f"logits differ by {(a - b).abs().max().item()}")
    if runs["eager"][1] != runs["graph"][1]:
        raise AssertionError(f"phase 22, {n_constrained} constrained rows: graph tokens "
                             f"{runs['graph'][1]} != eager {runs['eager'][1]}")
    saved.restore()
    del saved
    t0 = time.monotonic()
    engine.step()
    wall = (time.monotonic() - t0) * 1e3
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        engine.step()
        torch.cuda.synchronize()
    busy = sum(us for us, _ in device_kernels(prof).values()) / 1e3
    for s in seqs:
        engine.abort(s.request_id)
    return (f"{len(cons0)} constrained rows of {len(live)}: graph and eager steps bit-equal "
            f"over 8 steps with the host's mask updates; "
            + step_line("engine step (graph, 8 rows; device time from a trace of the next)",
                        wall, busy))


def mask_ms(builder, kind: str, token_ids, eos) -> tuple[float, float, int]:
    """Host ms of ``builder.mask`` at each recognizer state along a served
    output (a fresh recognizer of ``kind``): (median, largest, states)."""
    cons = recognizer(kind)
    st, times = cons.initial(), []
    for t in [None] + list(token_ids):
        if t is not None:
            st = builder.advance_with_token(cons, st, t)
        if st is None:
            break
        t0 = time.perf_counter()
        builder.mask(cons, st, eos)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), max(times), len(times)


def split_need(path: str, opts: dict, dev) -> tuple[int, int]:
    """The split state (workspace floats, counters) an engine of the GGUF
    at ``path`` reserves on ``dev`` with these options (its weights read on
    the CPU: the plans need only their shapes)."""
    pipe = load_pipeline(path, device="cpu")
    weights = llama.fuse_projections(pipe.weights, pipe.cfg)
    return llama.kernel_workspace(
        weights, pipe.cfg, opts["max_batch"],
        forward_rows(opts["max_batch"], opts["prefill_chunk"], 4),  # the scheduler's default
        decode_widths(opts["max_model_len"], opts["block_size"]), opts["block_size"],
        _cuda.sm_count(dev))


def constrained_serve(dev, name_line: str) -> dict:
    """Phase 22 (module docstring); returns the serve run's launch counts."""
    cfg = ModelConfig(**dict(LLAMA3_8B, eos_token_ids=(VocabTokenizer.EOS,)))
    # the split state only grows: drop what earlier phases grew it to, so
    # that the 8B's reservation is the one a second model meets (as on a
    # fresh server); no graph may hold it now
    check(_cuda._held[dev] == 0, "phase 22: a CUDA graph still holds the split state")
    _cuda._workspaces.pop(dev, None)
    _cuda._counters.pop(dev, None)
    t_w = time.monotonic()
    weights = build_weights(cfg, dev, SEED + 110)
    torch.cuda.synchronize()
    tok = VocabTokenizer(SEED + 111)
    log(f"  {cfg.num_layers}-layer weights drawn in {time.monotonic() - t_w:.1f} s; "
        f"tokenizer of {len(tok.pieces) + len(tok.special)} ids")
    engine = Engine(cfg, weights, num_blocks=96, block_size=64, max_batch=8,
                    max_model_len=1024, prefill_chunk=256, device=dev, seed=SEED,
                    tokenizer=tok)
    del weights
    seqs = []
    add_request = engine.add_request

    def recording_add_request(*a, **kw):
        seq = add_request(*a, **kw)
        seqs.append(seq)
        return seq

    engine.add_request = recording_add_request
    template = resolve_chat_template(
        override="{% for message in messages %}{{ message['content'] }}{% endfor %}")
    threads_before = set(threading.enumerate())
    server = Server(engine, tok, template, "llama3-8b-constrained", host="127.0.0.1", port=0)
    server.start()
    url = server.url

    def chat(i, extra, max_tokens=32):
        return {"messages": [{"role": "user", "content": f"request {i}: " + "give me data " * 6}],
                "max_tokens": max_tokens, "temperature": 0.0, **extra}

    bodies = {
        "json 0": ("/v1/chat/completions", chat(0, {"response_format": {"type": "json_object"}})),
        "json 1": ("/v1/chat/completions", chat(1, {"response_format": {"type": "json_object"},
                                                    "temperature": 0.8, "seed": 7})),
        "json_schema": ("/v1/chat/completions", chat(2, {"response_format": {
            "type": "json_schema", "json_schema": {"name": "person", "schema": PERSON_SCHEMA}}})),
        "regex": ("/v1/chat/completions",
                  chat(3, {"grammar": {"type": "regex", "value": REGEX_EMAIL}})),
        "choice": ("/v1/chat/completions",
                   chat(4, {"grammar": {"type": "choice", "value": CHOICES}})),
        "lark": ("/v1/chat/completions", chat(5, {"grammar": {"type": "lark",
                                                              "value": LARK_LIST}})),
        "dry": ("/v1/chat/completions", chat(6, {"dry_multiplier": 0.8, "dry_base": 1.75,
                                                 "dry_allowed_length": 2, "logprobs": True,
                                                 "top_logprobs": 3})),
        "completion": ("/v1/completions", {"prompt": "request 7: the plain one " * 3,
                                           "max_tokens": 32, "temperature": 0.0}),
    }
    kinds = {"json 0": "json", "json 1": "json", "json_schema": "json", "regex": "regex",
             "choice": "choice", "lark": "lark"}
    prompts = {name: (tok.encode(template.render(b["messages"])) if "messages" in b
                      else tok.encode(b["prompt"])) for name, (_, b) in bodies.items()}
    _cuda.reset_counts()
    t_s = time.monotonic()
    calls = {name: (lambda p=path, b=body: http(url, p, b)) for name, (path, body) in
             bodies.items()}
    msg_body = {"max_tokens": 8, "system": "be brief",
                "messages": [{"role": "user", "content": [{"type": "text", "text": "hello"}]}]}
    calls.update({
        "/v1/messages": lambda: http(url, "/v1/messages", msg_body),
        "/v1/messages/count_tokens": lambda: http(url, "/v1/messages/count_tokens", {
            "messages": [{"role": "user", "content": "count these"}]}),
        "/v1/responses": lambda: http(url, "/v1/responses",
                                      {"input": "respond", "max_output_tokens": 8,
                                       "temperature": 0.0}),
        "/v1/embeddings": lambda: http(url, "/v1/embeddings",
                                       {"input": ["embed this", "and this one, longer"]}),
        "/v1/system/info": lambda: http(url, "/v1/system/info"),
    })
    res = concurrently(calls)
    wall = time.monotonic() - t_s
    counts = dict(_cuda.COUNTS)
    for name, (status, body) in res.items():
        check(status == 200, f"phase 22 {name}: HTTP {status} {str(body)[:300]}")
    by_prompt = {tuple(s.prompt_ids): s for s in seqs}
    builder = engine._get_mask_builder()
    notes = []
    for name, kind in kinds.items():
        seq = by_prompt[tuple(prompts[name])]
        finish = res[name][1]["choices"][0]["finish_reason"]
        out = b"".join(builder.token_bytes[t] for t in seq.generated_ids)
        cons = recognizer(kind)
        st = cons.initial()
        for by in out:
            st = cons.advance(st, by)
            check(st is not None, f"phase 22 {name}: output {out!r} leaves its {kind} recognizer")
        if finish == "stop":
            check(cons.is_complete(st), f"phase 22 {name}: stopped on an incomplete {out!r}")
            if kind == "json":
                check(isinstance(json.loads(out.decode("utf-8")), dict),
                      f"phase 22 {name}: {out!r} is not a JSON object")
            if kind == "choice":
                check(out.decode() in CHOICES, f"phase 22 choice: {out!r}")
        else:
            check(finish == "length" and len(seq.generated_ids) == 32,
                  f"phase 22 {name}: finish {finish!r} after {len(seq.generated_ids)} tokens")
        notes.append(f"{name} {finish} after {len(seq.generated_ids)} tokens ({len(out)} bytes)")
    lp = res["dry"][1]["choices"][0]["logprobs"]["content"]
    check(len(lp) == 32 and all(len(e["top_logprobs"]) == 3 for e in lp),
          "phase 22 dry: logprobs")
    check(res["completion"][1]["object"] == "text_completion"
          and res["completion"][1]["usage"]["completion_tokens"] == 32, "phase 22 completion")
    m = res["/v1/messages"][1]
    check(m["type"] == "message" and m["content"][0]["type"] == "text"
          and m["usage"]["output_tokens"] == 8, f"phase 22 /v1/messages: {m}")
    n_count = len(tok.encode(template.render([{"role": "user", "content": "count these"}])))
    check(res["/v1/messages/count_tokens"][1] == {"input_tokens": n_count},
          "phase 22 count_tokens")
    emb = res["/v1/embeddings"][1]["data"]
    vecs = np.asarray([e["embedding"] for e in emb], np.float64)
    check(vecs.shape == (2, cfg.hidden_size) and np.isfinite(vecs).all()
          and np.allclose(np.linalg.norm(vecs, axis=1), 1.0, atol=1e-3),
          f"phase 22 embeddings: shape {vecs.shape}")
    info = res["/v1/system/info"][1]
    check(info["backend"] == torch.cuda.get_device_name(dev)
          and info["models"] == ["llama3-8b-constrained"], f"phase 22 system info: {info}")
    rid = res["/v1/responses"][1]["id"]
    check(http(url, f"/v1/responses/{rid}") == (200, res["/v1/responses"][1]),
          "phase 22 GET /v1/responses")
    check(http(url, f"/v1/responses/{rid}", method="DELETE") == (200, {"id": rid,
                                                                        "deleted": True}),
          "phase 22 DELETE /v1/responses")
    check(http(url, f"/v1/responses/{rid}")[0] == 404, "phase 22 GET after DELETE")
    status, metrics = http(url, "/metrics")
    check(status == 200 and 'route="/v1/chat/completions",status="200"} 7' in metrics
          and "engine_constraint_masks" in metrics, "phase 22 /metrics")
    missing = [k for k in DENSE_KERNELS if counts.get(k, 0) == 0]
    plain = {k: v for k, v in counts.items() if k.endswith("_plain") and v}
    if missing or plain:
        raise AssertionError(f"phase 22: kernels not launched {missing}, plain versions {plain}")
    st = engine.stats
    log(f"  served 8 requests (6 constrained, 1 DRY with logprobs, 1 completion) and 5 other "
        f"routes at once in {wall:.2f} s: {'; '.join(notes)}; {st['constraint_masks']} masks "
        f"in {st['constraint_mask_s']:.3f} s of host time; decode "
        f"{st['decode_time_s'] / st['decode_steps'] * 1e3:.1f} ms/step over "
        f"{st['decode_steps']} steps [{name_line}]")
    per_kind = []
    for kind, name in (("json", "json 0"), ("regex", "regex"), ("choice", "choice"),
                       ("lark", "lark")):
        med, mx, n = mask_ms(builder, kind, by_prompt[tuple(prompts[name])].generated_ids,
                             cfg.eos_token_ids)
        per_kind.append(f"{kind} {med:.2f} (max {mx:.2f}, {n} states)")
    log(f"  host ms per mask at V = {cfg.vocab_size}: {', '.join(per_kind)} [{name_line}]")

    # a second model beside the first: load, run both at once, unload
    q = {"prompt": "the same prompt for both runs", "max_tokens": 16, "temperature": 0.0}
    s_alone, big_alone = http(url, "/v1/completions", q)
    check(s_alone == 200, f"phase 22: completion alone HTTP {s_alone}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tiny-llama-q4k.gguf")
        write_tiny_llama_gguf(path, SEED + 112)
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        opts = {"num_blocks": 64, "block_size": 16, "max_batch": 4, "max_model_len": 512,
                "prefill_chunk": 64}
        t_l = time.monotonic()
        status, body = http(url, "/v1/models/load", {"model_id": "tiny", "path": path,
                                                     "engine_options": opts})
        load_s = time.monotonic() - t_l
        check(status == 200 and body == {"status": "loaded", "model_id": "tiny"},
              f"phase 22 load: {status} {body}")
        loaded = torch.cuda.memory_allocated(dev)
        tq = {"model": "tiny", "prompt": "tiny model prompt", "max_tokens": 24,
              "temperature": 0.0}
        s_tiny, tiny_alone = http(url, "/v1/completions", tq)
        check(s_tiny == 200, f"phase 22: tiny completion alone HTTP {s_tiny}")
        both = concurrently({
            **{f"big {i}": (lambda b=dict(q, model="llama3-8b-constrained",
                                          prompt=q["prompt"] if i == 0 else f"other {i}"):
                            http(url, "/v1/completions", b)) for i in range(3)},
            **{f"tiny {i}": (lambda b=dict(tq, prompt=tq["prompt"] if i == 0 else f"t {i}"):
                             http(url, "/v1/completions", b)) for i in range(3)},
        })
        check(all(s == 200 for s, _ in both.values()), "phase 22: requests to both models")
        held = torch.cuda.memory_allocated(dev)  # weights, pools, graphs of both widths
        check(both["big 0"][1]["choices"][0]["text"] == big_alone["choices"][0]["text"],
              "phase 22: the 8B's greedy text beside the second model differs from alone")
        check(both["tiny 0"][1]["choices"][0]["text"] == tiny_alone["choices"][0]["text"],
              "phase 22: the second model's greedy text beside the 8B differs from alone")
        big_opts = dict(opts, max_batch=1024)
        need, have = split_need(path, big_opts, dev), (_cuda.split_workspace(dev, 0).numel(),
                                                       _cuda.split_counters(dev, 0).numel())
        check(need[0] > have[0] or need[1] > have[1],
              f"phase 22: the wide load needs split state {need}, within the {have} held")
        status, body = http(url, "/v1/models/load", {"model_id": "tiny-wide", "path": path,
                                                     "engine_options": big_opts})
        check(status == 400 and "while a CUDA graph uses it" in body["error"]["message"],
              f"phase 22: a load that cannot reserve its split state answered {status} {body}")
        t_u = time.monotonic()
        status, body = http(url, "/v1/models/unload", {"model_id": "tiny"})
        unload_s = time.monotonic() - t_u
        check(status == 200 and body == {"status": "unloaded"}, f"phase 22 unload: {body}")
        check(http(url, "/v1/models/unload", {"model_id": "tiny"})[0] == 404,
              "phase 22: a second unload is not 404")
        gc.collect()
        after = torch.cuda.memory_allocated(dev)
        # against what the second model held, not the whole card's allocation
        check(abs(after - before) <= 0.01 * (held - before),
              f"phase 22: {after - before} bytes more allocated after the unload than before "
              f"the load; the model held {held - before}")
    log(f"  second model (2-layer Llama geometry, Q4_K GGUF): loaded in {load_s:.2f} s "
        f"(+{(loaded - before) / 2**20:.1f} MiB), both models served at once with the greedy "
        f"text each gives alone (+{(held - before) / 2**20:.1f} MiB held then); a load "
        f"needing split state {need} beyond the {have} held refused while graphs hold it; "
        f"unloaded in {unload_s:.2f} s, {after - before:+d} bytes allocated after against "
        f"before the load [{name_line}]")
    server.shutdown()
    for th in threading.enumerate():
        if th not in threads_before:
            th.join(10)
    leftover = [th.name for th in threading.enumerate()
                if th not in threads_before and th.is_alive()]
    check(not leftover, f"phase 22: threads still running after shutdown: {leftover}")
    del engine.add_request
    for k in (0, 1, 8):
        log(f"  {constrained_step_checks(engine, k, name_line)} [{name_line}]")
    engine.close()
    del engine, server
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def main() -> int:
    # phase 0
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain f32 matmuls stay f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    name_line = smi.stdout.strip().splitlines()[0]
    print(name_line, flush=True)
    kind = torch.cuda.get_device_name(0)
    rates = card_rates(kind)
    log(f"phase 0: device {kind} x{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; rates {rates[0] / 1e12:.2f} TB/s, "
        f"{rates[1] / 1e12:.0f} TFLOP/s bf16")
    # phase 1
    t_b = time.monotonic()
    _cuda.library()
    log(f"phase 1: kernels built and loaded in {time.monotonic() - t_b:.1f} s "
        f"(nvcc {_cuda.build_seconds if _cuda.build_seconds is not None else 'cached'} s)")
    # phase 2
    log("phase 2: kernels against their plain versions")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows: dict[str, list] = {k: [] for k in _cuda.KERNELS}
    for n, k in ((6144, 4096), (4096, 4096), (28672, 4096), (4096, 14336)):
        qt = q4k(n, k, gen, dev)
        for m in (1, 8, 512):
            rows["w4_matmul"].append(check_matmul("w4_matmul", m, qt, rates, gen, dev))
        del qt
    head = q8(128256, 4096, gen, dev)
    for m in (1, 8):
        rows["w8_matmul"].append(check_matmul("w8_matmul", m, head, rates, gen, dev))
    del head
    q6 = q6k(4096, 14336, gen, dev)  # Q6_K-style ffn_down
    for m in (8, 512):
        rows["w8_matmul"].append(check_matmul("w8_matmul", m, q6, rates, gen, dev))
    del q6
    attn_v = q8(1024, 4096, gen, dev)  # Mixtral-8x7B's Q8_0 attn_v
    for m in (8, 512):
        rows["w8_matmul"].append(check_matmul("w8_matmul", m, attn_v, rates, gen, dev))
    del attn_v
    q6_head = q6k(32000, 4096, gen, dev)  # Mixtral-8x7B's Q6_K head
    rows["w8_matmul"].append(check_matmul("w8_matmul", 8, q6_head, rates, gen, dev))
    del q6_head
    rows["paged_decode"].append(check_decode(rates, gen, dev))
    rows["paged_prefill"].append(check_prefill(rates, gen, dev))
    # the engine's prefill chunks: 4 prompts of 256 tokens (the scheduler's
    # max_prefill_seqs at chip_smoke's chunk), one 512-token chunk (the
    # Engine default) on 512 cached positions
    rows["paged_prefill"].append(check_prefill(rates, gen, dev, b=4, t=256,
                                               n_valid=(256,) * 4, past=(0,) * 4))
    rows["paged_prefill"].append(check_prefill(rates, gen, dev, b=1, t=512, n_valid=(512,),
                                               past=(512,)))
    check_prefill_edges(rows, rates, gen, dev)
    check_w4_edges(rows, rates, gen, dev)
    check_w8_edges(rows, rates, gen, dev)
    check_grouped_kernels(rows, rates, gen, dev)
    # DeepSeek-V2-Lite's banks (64 experts, top-6) at 6 decode tokens (n*k =
    # 36) and a 2 x 96-token prefill (1152)
    check_expert_banks(rows, rates, gen, dev, "V2-Lite", 64, 2048, 1408, 6, (6, 192), edges=True)
    for bs in (16, 64):
        rows["mla_decode"].append(check_mla(rates, gen, dev, bs))
    # paged decode at depth: one request at 8192 positions, 8 at 4096 each
    # (after the rows above, which keep the generator's stream of earlier runs)
    rows["paged_decode"].append(check_decode(rates, gen, dev, kv_lens=(8192,), w=128,
                                             dropped=0))
    rows["paged_decode"].append(check_decode(rates, gen, dev, kv_lens=(4096,) * 8, w=64,
                                             dropped=7))
    # phase 6's decode step of 1 token (n*k = 6)
    check_expert_banks(rows, rates, gen, dev, "V2-Lite", 64, 2048, 1408, 6, (1,))
    # MLA decode at depth: one request at 8192 positions, 8 at 4096 each
    rows["mla_decode"].append(check_mla(rates, gen, dev, 64, kv_lens=(8192,), positions=8192))
    rows["mla_decode"].append(check_mla(rates, gen, dev, 64, kv_lens=(4096,) * 8,
                                        positions=4096))
    # the paged kernels' quantized forms (after every other row, which keep
    # the generator's stream of earlier runs): decode at the table's row and
    # at 8 x 4096, prefill at B=2 T=128 on 300 past positions and 512 on 512
    for kvq in ("int8", "fp8"):
        dq, pq = rows[f"paged_decode_{kvq}"], rows[f"paged_prefill_{kvq}"]
        dq.append(check_decode(rates, gen, dev, kv_quant=kvq))
        dq.append(check_decode(rates, gen, dev, kv_lens=(4096,) * 8, w=64, dropped=7,
                               kv_quant=kvq))
        pq.append(check_prefill(rates, gen, dev, kv_quant=kvq))
        pq.append(check_prefill(rates, gen, dev, b=1, t=512, n_valid=(512,), past=(512,),
                                kv_quant=kvq))
    # Gemma-2-9B's attention (16/8 heads, head_dim 256, softcap 50; after
    # every other row, which keep the generator's stream of earlier runs):
    # decode at the table's row (a full layer), at 8 x 8192 on a sliding
    # layer (window 4096: the walk reads half the table), with a window off
    # the tile edge; prefill at B=2 T=128 on 300 past and 512 tokens on 3840
    # past through the window's edge; then Mistral-7B's 32/8 heads at
    # head_dim 128 with its 4096-position window
    gemma_attn = dict(n_q=16, n_kv=8, hd=256, softcap=50.0)
    dh, ph = rows["paged_decode_hd256"], rows["paged_prefill_hd256"]
    dh.append(check_decode(rates, gen, dev, **gemma_attn))
    dh.append(check_decode(rates, gen, dev, kv_lens=(8192,) * 8, w=128, dropped=7, window=4096,
                           **gemma_attn))
    dh.append(check_decode(rates, gen, dev, window=100, **gemma_attn))
    ph.append(check_prefill(rates, gen, dev, **gemma_attn))
    ph.append(check_prefill(rates, gen, dev, b=1, t=512, n_valid=(512,), past=(3840,),
                            window=4096, **gemma_attn))
    rows["paged_decode"].append(check_decode(rates, gen, dev, kv_lens=(8192,) * 8, w=128,
                                             dropped=7, window=4096))
    rows["paged_prefill"].append(check_prefill(rates, gen, dev, b=1, t=512, n_valid=(512,),
                                               past=(3840,), window=4096))
    # gpt-oss-20b's attention (64/8 heads, head_dim 64, sinks; after every
    # other row, which keep the generator's stream of earlier runs): decode
    # at the table's row (a full layer) and at 8 x 8192 on a sliding layer
    # (window 128); prefill at B=2 T=128 on 300 past and 512 tokens on 3840
    # past through the window; then its expert banks on the dense grouped
    # kernel (K = 2880)
    oss_attn = dict(n_q=64, n_kv=8, hd=64, sinks=True)
    d64, p64 = rows["paged_decode_hd64"], rows["paged_prefill_hd64"]
    d64.append(check_decode(rates, gen, dev, **oss_attn))
    d64.append(check_decode(rates, gen, dev, kv_lens=(8192,) * 8, w=128, dropped=7, window=128,
                            **oss_attn))
    p64.append(check_prefill(rates, gen, dev, **oss_attn))
    p64.append(check_prefill(rates, gen, dev, b=1, t=512, n_valid=(512,), past=(3840,),
                             window=128, **oss_attn))
    # gpt-oss-20b's banks (32 experts, top-4; K = 2880 = 45 x 64, N not a
    # multiple of the prefill body's 256 columns) at 8 decode tokens (n*k =
    # 32) and a 512-token prefill (2048)
    check_expert_banks(rows, rates, gen, dev, "gpt-oss", 32, 2880, 2880, 4, (8, 512))
    # the Qwen family (after every other row, which keep the generator's
    # stream of earlier runs): prefill at Qwen2.5-7B's heads (28/4, GQA group
    # 7: 9 tokens a query tile and one dead row) at B=2 T=128 on 300 past and
    # 512 tokens on 512, at group 5 (Qwen2.5-14B's 40/8), and its int8 form at
    # group 7; decode at group 7; the dense grouped kernel on Qwen3-30B-A3B's
    # 128-expert banks
    qwen_attn = dict(n_q=28, n_kv=4)
    rows["paged_prefill"].append(check_prefill(rates, gen, dev, **qwen_attn))
    rows["paged_prefill"].append(check_prefill(rates, gen, dev, b=1, t=512, n_valid=(512,),
                                               past=(512,), **qwen_attn))
    rows["paged_prefill"].append(check_prefill(rates, gen, dev, n_q=40, n_kv=8))
    rows["paged_prefill_int8"].append(check_prefill(rates, gen, dev, kv_quant="int8",
                                                    **qwen_attn))
    rows["paged_decode"].append(check_decode(rates, gen, dev, **qwen_attn))
    check_expert_banks(rows, rates, gen, dev, "Qwen3-30B-A3B", 128, 2048, 768, 8, (6, 256))
    # the quantized forms with every option (after every other row, which
    # keep the generator's stream of earlier runs): at Gemma-2-9B's heads,
    # decode at the table's row, at 8 x 8192 on a sliding layer (window
    # 4096) and with a window of 100 (the window's control), prefill at B=2
    # T=128 on 300 past (and with a window of 100: its control, untimed)
    # and 512 tokens on 3840 past through the window; at gpt-oss-20b's
    # heads the shapes of its bf16 rows (sinks: their control); then the
    # int8 form at head_dim 128 with Mistral-7B's 4096-position window
    for kvq in ("int8", "fp8"):
        dg, pg = rows[f"paged_decode_{kvq}_hd256"], rows[f"paged_prefill_{kvq}_hd256"]
        dg.append(check_decode(rates, gen, dev, kv_quant=kvq, **gemma_attn))
        dg.append(check_decode(rates, gen, dev, kv_lens=(8192,) * 8, w=128, dropped=7,
                               window=4096, kv_quant=kvq, **gemma_attn))
        dg.append(check_decode(rates, gen, dev, window=100, window_control=True, kv_quant=kvq,
                               **gemma_attn))
        pg.append(check_prefill(rates, gen, dev, kv_quant=kvq, **gemma_attn))
        pg.append(check_prefill(rates, gen, dev, b=1, t=512, n_valid=(512,), past=(3840,),
                                window=4096, kv_quant=kvq, **gemma_attn))
        pg.append(check_prefill(rates, gen, dev, window=100, window_control=True, timed=False,
                                kv_quant=kvq, **gemma_attn))
        do, po = rows[f"paged_decode_{kvq}_hd64"], rows[f"paged_prefill_{kvq}_hd64"]
        do.append(check_decode(rates, gen, dev, kv_quant=kvq, **oss_attn))
        do.append(check_decode(rates, gen, dev, kv_lens=(8192,) * 8, w=128, dropped=7,
                               window=128, kv_quant=kvq, **oss_attn))
        po.append(check_prefill(rates, gen, dev, kv_quant=kvq, **oss_attn))
        po.append(check_prefill(rates, gen, dev, b=1, t=512, n_valid=(512,), past=(3840,),
                                window=128, kv_quant=kvq, **oss_attn))
    rows["paged_decode_int8"].append(check_decode(rates, gen, dev, kv_lens=(8192,) * 8, w=128,
                                                  dropped=7, window=4096, kv_quant="int8"))
    rows["paged_prefill_int8"].append(check_prefill(rates, gen, dev, b=1, t=512, n_valid=(512,),
                                                    past=(3840,), window=4096,
                                                    kv_quant="int8"))
    # the wide-group forms (after every other row, which keep the generator's
    # stream of earlier runs): W4 at group 128 at Llama-3.1-8B's shapes as its
    # AWQ checkpoint stores them (gate-up, o, qkv, down), W8 at group 128 at
    # Qwen2.5-7B-GPTQ-Int8's (gate-up, down), then their edges
    for n, k, ms in ((28672, 4096, (8, 512)), (4096, 4096, (8,)), (6144, 4096, (8,)),
                     (4096, 14336, (8,))):
        qt = wide_layer(n, k, gen, dev, bits=4, awq=True)
        for m in ms:
            rows["w4_matmul_wide"].append(check_matmul("w4_matmul_wide", m, qt, rates, gen, dev))
        del qt
    for n, k, ms in ((37888, 3584, (8, 512)), (3584, 18944, (8,))):
        qt = wide_layer(n, k, gen, dev, bits=8)
        for m in ms:
            rows["w8_matmul_wide"].append(check_matmul("w8_matmul_wide", m, qt, rates, gen, dev))
        del qt
    check_wide_edges(rows, rates, gen, dev)
    torch.cuda.empty_cache()
    # the grouped forms' wide groups on GPTQ and AWQ expert banks, and the
    # decode kernel at GQA group 1 (after every other row, which keep the
    # generator's stream of earlier runs)
    check_wide_grouped(rows, rates, gen, dev)
    torch.cuda.empty_cache()
    # the GGUF forms: W4 at group 16 (Q2_K), W8 unsigned with a bias at
    # group 32 (Q5_K), Q3_K banks, Q4_0/Q4_1/Q5_0/Q5_1 (after every other
    # row, which keep the generator's stream of earlier runs)
    check_gguf_kernels(rows, rates, gen, dev)
    # the paged kernels at head_dim 96 and 80 (after every other row, which
    # keep the generator's stream of earlier runs)
    check_hd80_96(rows, rates, gen, dev)
    # the contiguous path's prefill at perplexity's rows (4 windows of 512:
    # M = 2048): W4 gate-up and down, the Q8_0 head (after every other row,
    # which keep the generator's stream of earlier runs)
    for n, k in ((28672, 4096), (4096, 14336)):
        qt = q4k(n, k, gen, dev)
        rows["w4_matmul"].append(check_matmul("w4_matmul", 2048, qt, rates, gen, dev))
        del qt
    head = q8(128256, 4096, gen, dev)
    rows["w8_matmul"].append(check_matmul("w8_matmul", 2048, head, rates, gen, dev))
    del head
    # the weight formats: FP8 on the W8 kernel's e4m3 form, HQQ-4 on W4 wide
    check_fp8_hqq(rows, rates, gen, dev)
    if KERNELS_ONLY:
        timed = [dict(name=k, **r) for k in _cuda.KERNELS for r in rows[k] if "ms" in r]
        log(f"kernels only: {len(timed)} timed rows [{name_line}]")
        print(json.dumps({"kernel_rows": timed, "card": name_line}), flush=True)
        return 0
    # phase 3
    log("phase 3: forward_paged at full width, 2 layers, kernels vs plain (bf16, int8 and "
        "fp8 pools)")
    model_counts = check_model(dev)
    torch.cuda.empty_cache()
    log("phase 3b: forward_paged at full Mixtral-8x7B width, 2 layers, kernels vs plain")
    check_mixtral_model(dev)
    torch.cuda.empty_cache()
    log("phase 3c: deepseek_forward_paged at full DeepSeek-V2-Lite width, 2 layers, "
        "kernels vs plain")
    check_deepseek_model(dev)
    torch.cuda.empty_cache()
    log("phase 3d: forward_paged at full Gemma-2-9B width, 2 layers (sliding, full), kernels "
        "vs plain (bf16, int8 and fp8 pools)")
    gemma_model = check_gemma_model(dev)
    torch.cuda.empty_cache()
    log("phase 3e: forward_paged at full gpt-oss-20b width, 2 layers (sliding, full), "
        "kernels vs plain (bf16, int8 and fp8 pools)")
    oss_model = check_gpt_oss_model(dev)
    torch.cuda.empty_cache()
    log("phase 3f: forward_paged at full Qwen2.5-7B width, 2 layers (GQA group 7, q/k/v "
        "biases), kernels vs plain")
    check_qwen_model(dev, QWEN25_7B, SEED + 16, "qwen2.5-7b model", QWEN_KERNELS)
    torch.cuda.empty_cache()
    log("phase 3g: forward_paged at full Qwen3-30B-A3B width, 2 layers (q/k norm, 128 experts "
        "top-8), kernels vs plain")
    check_qwen_model(dev, QWEN3_30B_A3B, SEED + 18, "qwen3-30b-a3b model", QWEN_MOE_KERNELS)
    torch.cuda.empty_cache()
    log("phase 3h: forward_paged at full Gemma-3-27B width, 2 layers (sliding with the local "
        "rope base, full with the global one), kernels vs plain over fp8 pools")
    gemma3_model = check_gemma3_model(dev)
    torch.cuda.empty_cache()
    log("phase 3i: forward_paged at full Qwen2.5-7B width, 2 layers, as its GPTQ-Int4 and "
        "GPTQ-Int8 checkpoints (group 128), kernels vs plain")
    gptq4_model = check_wide_model(dev, GPTQ_INT4, SEED + 30, "qwen2.5-7b gptq-int4 model",
                                   WIDE_W4_KERNELS)
    torch.cuda.empty_cache()
    gptq8_model = check_wide_model(dev, GPTQ_INT8, SEED + 32, "qwen2.5-7b gptq-int8 model",
                                   WIDE_W8_KERNELS)
    torch.cuda.empty_cache()
    log("phase 3j: forward_paged at full Qwen1.5-MoE-A2.7B width, 2 layers, as its GPTQ-Int4 "
        "checkpoint (60 experts top-4, gated shared expert; group 128), kernels vs plain")
    q15_model = check_quantized_moe_model(dev, QWEN15_MOE_A27B, GPTQ_INT4, SEED + 34,
                                          "qwen1.5-moe-a2.7b gptq-int4 model",
                                          QWEN15_MOE_KERNELS, NEAR_TIE_ULPS)
    torch.cuda.empty_cache()
    log("phase 3k: forward_paged at full Mixtral-8x7B width, 2 layers, as its AWQ checkpoint "
        "(group 128), kernels vs plain")
    mixtral_awq_model = check_quantized_moe_model(dev, MIXTRAL_8X7B, AWQ_INT4, SEED + 36,
                                                  "mixtral-8x7b awq model", MIXTRAL_AWQ_KERNELS)
    torch.cuda.empty_cache()
    log("phase 3l: forward_paged at full Qwen2.5-7B and Qwen3-30B-A3B width, 2 layers each, "
        "as their Q5_K_M and Q2_K-mix GGUF files store them (through load_gguf_model), "
        "kernels vs plain; the planarizers on the card against the CPU")
    check_planarizers(dev)
    q5km_model = check_gguf_model(dev, QWEN25_7B, q5_k_m(2), SEED + 46,
                                  "qwen2.5-7b q5_k_m gguf model", GGUF_Q5KM_KERNELS)
    torch.cuda.empty_cache()
    q2k_model = check_gguf_model(dev, QWEN3_30B_A3B, q2_k_mix, SEED + 48,
                                 "qwen3-30b-a3b q2_k gguf model", GGUF_Q2K_KERNELS,
                                 NEAR_TIE_ULPS)
    torch.cuda.empty_cache()
    log("phase 3m: in-situ quantization: each ISQ type's bytes on the card against the CPU; "
        "forward_paged at full Mixtral-8x7B and Qwen1.5-MoE-A2.7B width, 2 layers each, as bf16 "
        "checkpoints quantized to Q4_K at load, kernels vs plain")
    isq_rates = check_isq_bytes(dev)
    isq_mixtral_model = check_isq_model(dev, MIXTRAL_8X7B, SEED + 58, "mixtral-8x7b isq q4k model",
                                        ISQ_MOE_KERNELS)
    torch.cuda.empty_cache()
    isq_q15_model = check_isq_model(dev, QWEN15_MOE_A27B, SEED + 60,
                                    "qwen1.5-moe-a2.7b isq q4k model",
                                    ISQ_MOE_KERNELS + ("dense_matmul_g",), "noise")
    torch.cuda.empty_cache()
    log("phase 3n: forward_paged at full width of the Llama-family variants, 2 layers each, "
        "drawn as bf16 HF checkpoints (Phi-3-mini and Phi-2 over bf16, int8 and fp8 pools; "
        "StarCoder2-7B, StableLM-2-1.6B, Aya-23-8B, Granite-3.1-8B, GLM-4-9B-0414, SmolLM3-3B), "
        "kernels vs plain")
    variant_models = check_variant_models(dev)
    torch.cuda.empty_cache()
    log("phase 3o: llama.forward over the contiguous caches at full width, 2 layers each "
        "(Llama-3-8B Q4_K over KVCache, Mixtral-8x7B Q4_K_M over KVCache, Gemma-2-9B bf16 over "
        "HybridKVCache past its 4096 window), kernels vs plain vs forward_paged")
    contiguous_models = check_contiguous_models(dev)
    torch.cuda.empty_cache()
    log("phase 3p: the weight formats at full Llama-3.1-8B width, 2 layers: an NF4 directory "
        "(ISQ Q4_K, and a Q2_K/Q3_K topology), a mistral.rs UQFF overlay, quantize to GGUF, "
        "kernels vs plain")
    format_models = check_format_models(dev)
    torch.cuda.empty_cache()
    # phase 4
    log("phase 4: serve the 32-layer Llama-3-8B geometry (bf16, then int8 KV pools)")
    torch.cuda.reset_peak_memory_stats(dev)
    counts, q8_counts = serve(dev, name_line, ModelConfig(**LLAMA3_8B), build_weights,
                              SEED + 3, "llama3-8b-geometry-q4k", DENSE_KERNELS,
                              quant=("int8", QUANT_KERNELS, 12))
    log(f"  peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    # phase 5
    log("phase 5: serve the 32-layer Mixtral-8x7B geometry (Q4_K_M recipe)")
    torch.cuda.reset_peak_memory_stats(dev)
    moe_counts, _ = serve(dev, name_line, ModelConfig(**MIXTRAL_8X7B), build_mixtral,
                          SEED + 6, "mixtral-8x7b-geometry-q4km",
                          ("w4_matmul_g", "w8_matmul_g") + DENSE_KERNELS)
    log(f"  peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB "
        f"[{name_line}]")
    # phase 6
    log("phase 6: serve the 27-layer DeepSeek-V2-Lite geometry (bf16)")
    torch.cuda.reset_peak_memory_stats(dev)
    ds_counts, _ = serve(dev, name_line, deepseek.DeepseekConfig(**DEEPSEEK_V2_LITE),
                         lambda cfg, dev_, seed: deepseek.init_random_weights(cfg, seed=seed,
                                                                              device=dev_),
                         SEED + 9, "deepseek-v2-lite-geometry-bf16", DEEPSEEK_KERNELS,
                         adapter_cls=DeepseekAdapter)
    log(f"  peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB "
        f"[{name_line}]")
    # phase 7
    log("phase 7: serve the 42-layer Gemma-2-9B geometry (bf16; one prompt past position 4096)")
    torch.cuda.reset_peak_memory_stats(dev)
    gemma_counts, _ = serve(dev, name_line, ModelConfig(**GEMMA2_9B), build_gemma, SEED + 12,
                            "gemma-2-9b-geometry-bf16", GEMMA_KERNELS, num_blocks=192,
                            max_model_len=8192, sizes=(40, 97, 180, 290, 430, 4400))
    log(f"  peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB "
        f"[{name_line}]")
    # phase 8
    log("phase 8: serve the 24-layer gpt-oss-20b geometry (bf16; windows of 128)")
    torch.cuda.reset_peak_memory_stats(dev)
    oss_counts, _ = serve(dev, name_line, ModelConfig(**GPT_OSS_20B), build_gpt_oss, SEED + 15,
                          "gpt-oss-20b-geometry-bf16", GPT_OSS_KERNELS)
    log(f"  peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB "
        f"[{name_line}]")
    # phase 9
    log("phase 9: serve the 28-layer Qwen2.5-7B geometry (bf16; GQA group 7, a 600-token "
        "prompt over 3 chunks)")
    torch.cuda.reset_peak_memory_stats(dev)
    q25_counts, _ = serve(dev, name_line, ModelConfig(**QWEN25_7B), build_qwen, SEED + 20,
                          "qwen2.5-7b-geometry-bf16", QWEN_KERNELS)
    log(f"  peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB "
        f"[{name_line}]")
    # phase 10
    log(f"phase 10: serve the {QWEN3_30B_A3B['num_layers']}-layer Qwen3-30B-A3B geometry "
        f"(bf16; 128 experts top-8)")
    torch.cuda.reset_peak_memory_stats(dev)
    q3_counts, _ = serve(dev, name_line, ModelConfig(**QWEN3_30B_A3B), build_qwen, SEED + 21,
                         "qwen3-30b-a3b-geometry-bf16", QWEN_MOE_KERNELS)
    log(f"  peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB "
        f"[{name_line}]")
    # phase 11
    log(f"phase 11: serve the {GEMMA3_12B['num_layers']}-layer Gemma-3-12B geometry from int8 KV "
        f"pools (bf16 weights; one prompt of 2500 tokens past its 1024 window)")
    torch.cuda.reset_peak_memory_stats(dev)
    g3_counts, _ = serve(dev, name_line, ModelConfig(**GEMMA3_12B), build_gemma, SEED + 24,
                         "gemma-3-12b-geometry-int8-kv", quant_names(GEMMA_KERNELS, "int8"),
                         kv_quant="int8", num_blocks=160, max_model_len=4096,
                         sizes=(40, 97, 180, 290, 430, 2500))
    log(f"  peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB "
        f"[{name_line}]")
    # phase 12
    log(f"phase 12: serve the {LLAMA31_8B['num_layers']}-layer Llama-3.1-8B geometry as its AWQ "
        f"INT4 checkpoint stores it (group 128; f16 embedding and head as bf16)")
    torch.cuda.reset_peak_memory_stats(dev)
    awq_counts, _ = serve(dev, name_line, ModelConfig(**LLAMA31_8B),
                          lambda cfg, dev_, seed: build_quantized(cfg, dev_, seed, AWQ_INT4),
                          SEED + 27, "llama-3.1-8b-awq-int4-geometry", WIDE_W4_KERNELS)
    bodies = {b: awq_counts.get(f"w4_matmul_wide.{b}", 0) for b in ("decode", "prefill")}
    check(all(bodies.values()), f"phase 12: w4_matmul_wide bodies launched {bodies}")
    log(f"  peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB "
        f"[{name_line}]")
    # phase 13
    log(f"phase 13: serve the {QWEN15_MOE_A27B['num_layers']}-layer Qwen1.5-MoE-A2.7B geometry "
        f"as its GPTQ-Int4 checkpoint stores it (group 128; f16 embedding, head, routers and "
        f"shared-expert gates as bf16)")
    torch.cuda.reset_peak_memory_stats(dev)
    q15_counts, _ = serve(dev, name_line, ModelConfig(**QWEN15_MOE_A27B),
                          lambda cfg, dev_, seed: build_quantized(cfg, dev_, seed, GPTQ_INT4),
                          SEED + 38, "qwen1.5-moe-a2.7b-gptq-int4-geometry", QWEN15_MOE_KERNELS)
    bodies = {f"{k}.{b}": q15_counts.get(f"{k}.{b}", 0)
              for k in QWEN15_MOE_KERNELS[:2] for b in ("decode", "prefill")}
    check(all(bodies.values()), f"phase 13: grouped wide bodies launched {bodies}")
    log(f"  peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB "
        f"[{name_line}]")
    # phase 14
    q25 = gguf_config(QWEN25_7B)
    log(f"phase 14: serve the {q25.num_layers}-layer Qwen2.5-7B-Instruct geometry as its "
        f"Q5_K_M GGUF file stores it (Q5_K, Q6_K on half of attn_v and ffn_down and the head; "
        f"drawn as the loader reads it)")
    torch.cuda.reset_peak_memory_stats(dev)
    q5km_counts, _ = serve(dev, name_line, q25,
                           lambda cfg, dev_, seed: build_gguf(cfg, dev_, seed,
                                                              q5_k_m(cfg.num_layers)),
                           SEED + 50, "qwen2.5-7b-instruct-q5_k_m-gguf", GGUF_Q5KM_KERNELS)
    bodies = {b: q5km_counts.get(f"w8_matmul.{b}", 0) for b in ("decode", "prefill")}
    check(all(bodies.values()), f"phase 14: w8_matmul bodies launched {bodies}")
    log(f"  peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB "
        f"[{name_line}]")
    # phase 15
    q3 = gguf_config(QWEN3_30B_A3B)
    log(f"phase 15: serve the {q3.num_layers}-layer Qwen3-30B-A3B geometry as a Q2_K-mix GGUF "
        f"file stores it (Q2_K attention q/k/o, gate/up banks and embedding; Q3_K attn_v and down "
        f"banks; a Q6_K head; drawn as the loader reads it)")
    torch.cuda.reset_peak_memory_stats(dev)
    q2k_counts, _ = serve(dev, name_line, q3,
                          lambda cfg, dev_, seed: build_gguf(cfg, dev_, seed, q2_k_mix),
                          SEED + 52, "qwen3-30b-a3b-q2_k-gguf", GGUF_Q2K_KERNELS)
    bodies = {f"{k}.{b}": q2k_counts.get(f"{k}.{b}", 0)
              for k in GGUF_Q2K_KERNELS[:2] for b in ("decode", "prefill")}
    check(all(bodies.values()), f"phase 15: W4 group-16 bodies launched {bodies}")
    log(f"  peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB "
        f"[{name_line}]")
    # phase 16
    log(f"phase 16: serve the {LLAMA31_8B['num_layers']}-layer Llama-3.1-8B geometry as a bf16 "
        f"checkpoint quantized in situ to Q4_K at load (Q8_0 embedding and head)")
    torch.cuda.reset_peak_memory_stats(dev)
    isq_stats: dict = {}
    isq_counts, _ = serve(dev, name_line, ModelConfig(**LLAMA31_8B),
                          lambda cfg, dev_, seed: build_isq(cfg, dev_, seed, isq_stats),
                          SEED + 62, "llama-3.1-8b-isq-q4k", DENSE_KERNELS)
    bodies = {b: isq_counts.get(f"w4_matmul.{b}", 0) for b in ("decode", "prefill")}
    check(all(bodies.values()), f"phase 16: w4_matmul bodies launched {bodies}")
    log(f"  ISQ load {isq_stats['seconds']:.2f} s for {isq_stats['weights'] / 1e9:.3f} G weights "
        f"({isq_stats['ms_per_million']:.3f} ms per million; 1024 x 4096 alone: "
        + ", ".join(f"{k} {v:.3f}" for k, v in isq_rates.items())
        + f"), peak during the load {isq_stats['peak_gib']:.2f} GiB; W4 launches "
        f"{isq_counts.get('w4_matmul', 0)}, W8 {isq_counts.get('w8_matmul', 0)}; peak device "
        f"memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB [{name_line}]")
    # phase 17
    phi3 = variant_config("phi3")
    log(f"phase 17: serve the {phi3.num_layers}-layer Phi-3-mini-4k-instruct geometry as a bf16 "
        f"HF checkpoint through the HF loader (fused projections split at load; one prompt of "
        f"2500 tokens past its 2047 window), then from int8 KV pools")
    torch.cuda.reset_peak_memory_stats(dev)
    phi3_counts, phi3_q8_counts = serve(
        dev, name_line, phi3, build_variant, SEED + 90, "phi-3-mini-4k-instruct-geometry-bf16",
        PHI3_KERNELS, quant=("int8", quant_names(PHI3_KERNELS, "int8"), 24), num_blocks=160,
        max_model_len=4096, sizes=(40, 97, 180, 290, 430, 2500))
    log(f"  peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB "
        f"[{name_line}]")
    # phase 18
    phi2 = variant_config("phi2")
    log(f"phase 18: serve the {phi2.num_layers}-layer Phi-2 geometry as a bf16 checkpoint "
        f"quantized in situ to Q4_K at load (Q8_0 embedding and head; biases and LayerNorms "
        f"dense)")
    torch.cuda.reset_peak_memory_stats(dev)
    phi2_stats: dict = {}
    phi2_counts, _ = serve(dev, name_line, phi2,
                           lambda cfg, dev_, seed: build_isq(cfg, dev_, seed, phi2_stats),
                           SEED + 92, "phi-2-isq-q4k", PHI2_ISQ_KERNELS)
    bodies = {b: phi2_counts.get(f"w4_matmul.{b}", 0) for b in ("decode", "prefill")}
    check(all(bodies.values()), f"phase 18: w4_matmul bodies launched {bodies}")
    log(f"  ISQ load {phi2_stats['seconds']:.2f} s for {phi2_stats['weights'] / 1e9:.3f} G "
        f"weights; W4 launches {phi2_counts.get('w4_matmul', 0)}, W8 "
        f"{phi2_counts.get('w8_matmul', 0)}; peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB [{name_line}]")
    # phase 19
    log(f"phase 19: the calibration loop on the {LLAMA31_8B['num_layers']}-layer Llama-3.1-8B "
        f"geometry (bf16 checkpoint): imatrix in f32, ISQ to Q4_K with and without it, "
        f"perplexity of the three models, generate, embed")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    calib_counts = calibration_loop(dev, name_line)
    log(f"  peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB "
        f"[{name_line}]")
    # phase 20
    log(f"phase 20: serve the {LLAMA31_8B['num_layers']}-layer Llama-3.1-8B geometry quantized "
        f"on the card to HQQ-4 (group 64), saved as a .uqff file and loaded back through "
        f"load_pipeline")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    hqq_stats: dict = {}

    def build_hqq(cfg, dev_, seed):
        weights = build_hqq_uqff(cfg, dev_, seed, hqq_stats)
        _, note, _ = two_layer_runs(dev_, cfg, weights, seed + 1, "llama-3.1-8b hqq4 model",
                                    HQQ_KERNELS)
        log(f"  the file's {cfg.num_layers} layers, kernels vs plain: {note}")
        return weights

    hqq_counts, _ = serve(dev, name_line, ModelConfig(**LLAMA31_8B), build_hqq, SEED + 100,
                          "llama-3.1-8b-hqq4-uqff", HQQ_KERNELS)
    bodies = {b: hqq_counts.get(f"w4_matmul_wide.{b}", 0) for b in ("decode", "prefill")}
    check(all(bodies.values()), f"phase 20: w4_matmul_wide bodies launched {bodies}")
    log(f"  HQQ {hqq_stats['hqq_s']:.2f} s on the card; .uqff of "
        f"{hqq_stats['bytes'] / 2**30:.2f} GiB written in {hqq_stats['write_s']:.2f} s, read "
        f"back in {hqq_stats['read_s']:.2f} s (then deleted); peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; {host_rss()} [{name_line}]")
    # phase 21
    log(f"phase 21: serve the {LLAMA31_8B['num_layers']}-layer Llama-3.1-8B geometry with its "
        f"projections in blockwise FP8 (128 x 128 scales); a 2-layer .uqff round trip of FP8 "
        f"weights")
    torch.cuda.reset_peak_memory_stats(dev)
    fp8_stats: dict = {}
    fp8_counts, _ = serve(dev, name_line, ModelConfig(**LLAMA31_8B),
                          lambda cfg, dev_, seed: build_fp8(cfg, dev_, seed, fp8_stats),
                          SEED + 101, "llama-3.1-8b-fp8-blockwise", FP8_KERNELS)
    bodies = {b: fp8_counts.get(f"w8_matmul_e4m3.{b}", 0) for b in ("decode", "prefill")}
    check(all(bodies.values()), f"phase 21: w8_matmul_e4m3 bodies launched {bodies}")
    log(f"  FP8 quantization {fp8_stats['seconds']:.2f} s on the card; peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; {host_rss()} [{name_line}]")
    fp8_model = check_fp8_uqff(dev)
    torch.cuda.empty_cache()
    # phase 22
    log(f"phase 22: serve the {LLAMA3_8B['num_layers']}-layer Llama-3-8B geometry (Q4_K) with "
        f"a 128256-id tokenizer: JSON, regex, choice and Lark constraints, DRY, the text routes, "
        f"a second model loaded, served and unloaded beside it")
    torch.cuda.reset_peak_memory_stats(dev)
    t22 = time.monotonic()
    constrained_counts = constrained_serve(dev, name_line)
    log(f"  phase 22 took {time.monotonic() - t22:.1f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; {host_rss()} [{name_line}]")
    # phase 23: the summary, one entry per kernel at the main path's dominant shape
    # (W4: decode M=8 gate-up; W8: decode M=8 lm_head; grouped: decode,
    # fused gate/up for W4, the Q6_K down bank for W8, DeepSeek-V2-Lite's
    # gate/up bank for dense; MLA: 64-token blocks), errors the worst of all
    # checks; launches summed over the runs of each kernel's path (module
    # docstring), each run's beside them
    main_shape = {"w4_matmul": "M=8 N=28672 K=4096", "w8_matmul": "M=8 N=128256 K=4096",
                  "w4_matmul_wide": "M=8 N=28672 K=4096", "w8_matmul_wide": "M=8 N=37888 K=3584",
                  "w4_matmul_g": "gate/up, fused: E=8 N=28672 K=4096 n*k=16",
                  "w8_matmul_g": "Q6_K down: E=8 N=4096 K=14336 n*k=16",
                  "w4_matmul_wide_g": "Qwen1.5-MoE gate/up, fused: E=60 N=2816 K=2048 n*k=32",
                  "w8_matmul_wide_g": "Qwen1.5-MoE down (u8, bias): E=60 N=2048 K=1408 n*k=32",
                  "w4_matmul_g16": "M=8 N=4096 K=2048",
                  "w8_matmul_e4m3": "M=8 N=28672 K=4096",
                  "w4_matmul_g16_g": "Qwen3-30B-A3B Q2_K gate/up, fused: E=128 N=1536 K=2048 "
                                     "n*k=48",
                  "dense_matmul_g": "V2-Lite gate/up: E=64 N=2816 K=2048 n*k=36",
                  "mla_decode": "B=8 nh=16 D=576 rank=512 bs=64 kv_lens 0..2048"}
    # the fp8 forms and the int8 head_dim-64 forms run in the phase-3 model
    # checks alone (their kernel runs' counts of those forms)
    fp8 = ("paged_decode_fp8", "paged_prefill_fp8")
    runs = {"llama3-8b serve": counts, "llama3-8b int8-kv serve": q8_counts,
            "phase 3 fp8-kv model": {k: model_counts["fp8"][k] for k in fp8},
            "phase 3d fp8-kv model": {k: gemma_model["fp8"][k]
                                      for k in quant_names(GEMMA_KERNELS, "fp8")},
            "phase 3e int8-kv model": {k: oss_model["int8"][k]
                                       for k in quant_names(GPT_OSS_KERNELS[:2], "int8")},
            "phase 3e fp8-kv model": {k: oss_model["fp8"][k]
                                      for k in quant_names(GPT_OSS_KERNELS[:2], "fp8")},
            "phase 3h fp8-kv model": {k: gemma3_model[k] for k in fp8},
            "mixtral-8x7b serve": moe_counts,
            "deepseek-v2-lite serve": ds_counts, "gemma-2-9b serve": gemma_counts,
            "gpt-oss-20b serve": oss_counts, "qwen2.5-7b serve": q25_counts,
            "qwen3-30b-a3b serve": q3_counts, "gemma-3-12b int8-kv serve": g3_counts,
            "phase 3i gptq-int4 model": gptq4_model, "phase 3i gptq-int8 model": gptq8_model,
            "llama-3.1-8b awq-int4 serve": awq_counts,
            "phase 3j qwen1.5-moe gptq-int4 model": q15_model,
            "phase 3k mixtral awq model": mixtral_awq_model,
            "qwen1.5-moe-a2.7b gptq-int4 serve": q15_counts,
            "phase 3l qwen2.5-7b q5_k_m model": q5km_model,
            "phase 3l qwen3-30b-a3b q2_k model": q2k_model,
            "qwen2.5-7b q5_k_m gguf serve": q5km_counts,
            "qwen3-30b-a3b q2_k gguf serve": q2k_counts,
            "phase 3m mixtral isq q4k model": isq_mixtral_model,
            "phase 3m qwen1.5-moe isq q4k model": isq_q15_model,
            "llama-3.1-8b isq q4k serve": isq_counts,
            **{f"phase 3n {kind} {kvq or 'bf16'}-kv model": c
               for (kind, kvq), c in variant_models.items()},
            "phi-3-mini serve": phi3_counts, "phi-3-mini int8-kv serve": phi3_q8_counts,
            "phi-2 isq q4k serve": phi2_counts,
            **{f"phase 3o {kind} contiguous model": c for kind, c in contiguous_models.items()},
            "phase 19 q4k perplexity": calib_counts,
            **{f"phase 3p {what} model": c for what, c in format_models.items()},
            "llama-3.1-8b hqq4 uqff serve": hqq_counts, "llama-3.1-8b fp8 serve": fp8_counts,
            "phase 21 fp8 uqff model": fp8_model,
            "llama3-8b constrained serve": constrained_counts}
    by_run = {k: {run: c[k] for run, c in runs.items() if c.get(k, 0)} for k in _cuda.KERNELS}
    unlaunched = [k for k in _cuda.KERNELS if not by_run[k]]
    if unlaunched:
        raise AssertionError(f"kernels launched in no run of the main path: {unlaunched}")
    entries = []
    for kname in _cuda.KERNELS:
        kr = rows[kname]
        pick = next((r for r in kr if "ms" in r and kname in main_shape
                     and r["shape"].startswith(main_shape[kname])), kr[0])
        src, replaces = KERNEL_INFO[kname]
        entries.append({
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(by_run[kname].values()), "launches_by_run": by_run[kname],
            "max_abs_err": max(r["max_abs_err"] for r in kr),
            "ms": pick["ms"], "device_ms": pick["device_ms"], "plain_ms": pick["plain_ms"],
            "bound_ms": pick["bound_ms"],
            "bound_by": pick["bound_by"], "library_ms": pick["library_ms"],
            "library_device_ms": pick["library_device_ms"], "shape": pick["shape"],
        })
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024  # KiB → bytes
    log(f"done in {time.monotonic() - T0:.1f} s, peak host memory (RSS) {rss / 1e9:.2f} GB "
        f"of the {HOST_BUDGET / 1e9:.0f} GB budget [{name_line}]")
    check(rss <= HOST_BUDGET, f"peak host memory {rss} bytes is over the budget")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    code = main()
    faulthandler.cancel_dump_traceback_later()
    sys.exit(code)
