#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phase 1 builds the hand-written CUDA kernels from ``src/repro_torch/csrc``
and holds each one, at the main paths' full-width shapes, against its plain
PyTorch version on the same inputs, row by row with a relative tolerance
(the f32 paged decode kernel also bit for bit against the contiguous one
on the same rows, the prefill kernel's last rows bit for bit between a
full and a suffix prefill, each column of a 13-metric bootstrap chunk bit
for bit against a call on it alone); it times the kernel, the plain
version and a library yardstick where one exists, with CUDA events (the
prefill kernel also by its device time in a profiler trace, and its
wrapper's host time; every other kernel also by the device time of a
whole call, whose device kernels are summed, and which fails unless the
trace holds every device kernel the call launches: one per group of 8
columns for the bootstrap partials), and logs
the registers, spills and shared memory of all eight kernels from the
runtime, failing on any spill.  The bootstrap kernels' bounds count the
integer work of every Poisson draw (``DRAW_ALU_OPS`` on the ALU,
``DRAW_INSTRUCTIONS`` issued).  The decode kernel
is also held and timed at the main path's own lengths (11..45), and the
four attention kernels also at phase 10's G = 8 (32 query heads over 4 KV
heads) and phase 11's G = 5 (40 over 8) at their shapes; kernels 1 and 2
at phase 12's head width of 112 (G = 1), kernel 8 at its state of 64 (112
heads).  Every task of phases
2-5 streams (``StreamingConfig(enabled=True)``) unless it says otherwise.
Phase 2
runs the contiguous main path through the user's entry point,
``EvalSession.run_task``, on full-width qwen3-4b with random bf16 weights
over 32 QA rows (phases 2, 5 and 6 run two chunks),
and checks that its kernels
launched there, that the greedy tokens of a prompt do not depend on the
batch around it, and that the logits are finite.  Phase 3 runs the paged
path: ``run_task`` over 32 few-shot prompts (a ~464-token header of worked
examples shared by every prompt) with the f32 page pool and prefix
sharing, then with the int8 pool, and gates through ``infer_batch``: paged
without sharing and paged under preemption give the contiguous engine's
texts.  Phase 4 runs Mamba2: ``run_task`` on full-width mamba2-2.7b over
the same few-shot prompts, every prefill layer through the SSD kernel,
then gates the greedy tokens' batch invariance, the prefill-to-decode
hand-off of the SSM state and the reuse of a slot.  Phase 5, in phase 2's
session, runs ``run_task`` with the seven ported metrics (five lexical,
``embedding_similarity`` and ``bertscore``) under the default
``ci_method="bca"``: BERTScore goes through its kernel once per chunk, and
each metric is range-checked by its kind (lexical in [0, 1], cosine in
[-1, 1], BERTScore finite, every interval bracketing its value); then the
same task with the default ``StreamingConfig()``, which runs in memory (BCa
over exact multinomial resamples drawn on the card, per-example scores
kept), and streaming under ``ci_method="analytical"``, which must launch no
bootstrap partials; then the statistics API ``bootstrap_ci`` over a
million scores at B = 1,000 through the bootstrap-means kernel, its means
held against the plain version and its width against the t-interval's.
Phase 6 runs the comparison path in one session holding full-width
qwen3-4b and mamba2-2.7b: ``run_suite`` over both models x an in-memory
task and a streaming one (``backend="device"``), serially and then with
``parallel_jobs=2`` (every job's texts, scores, metrics, streaming state
and comparisons equal to the serial run's); the significance matrix
(every shared metric compared, p-values in [0, 1], the in-memory
recommendations and tests equal to ``recommend_test`` and
``compare_scores`` rerun on the CPU from the card's scores, the streaming
test the paired bootstrap over kernel 6's replicates); the response cache
(a second run with no engine call, ``CacheMiss`` under ``REPLAY``);
``rescore_stages`` with BERTScore (no engine call, kernel 7 launched);
single-flight over 32 rows of 16 prompts (16 engine calls, 16 coalesced);
kernels 1, 2, 6, 7 and 8 must launch in the phase; then the engines'
tokenizers encode all 64 of phase 8's prompts.  Phase 7, the harness
around inference, runs in phase 2's session on its qwen3-4b engine (no new
weights), over 16 rows (one chunk): (a) phase 2's task on the lock-step
path (``use_service=False``, two workers, two shards a chunk) in memory
and streaming over 16 rows (one chunk), bit for bit the service path's
texts, scores, metrics and streaming state on the same rows, with its
engine calls and cache counts, and the worker pool's counts filled; (b) the RAG task
(``rag_examples(16)``, ``llm_judge``, the five RAG metrics,
``exact_match``) with the task's own engine as judge, the judge's launches
of kernels 1 and 2 counted apart from the task's: every random-weight
judge answer is unparseable and logged, each judge metric is the
reference's empty result (NaN, method ``"none"``, ``n`` 0) in memory and
streaming (``backend="device"``, kernel 6 giving the NaN columns zero
weight), the other RAG metrics equal their host recomputation from the
card's texts; (c) the same task judged by the simulated API engine: the
card's answers equal (b)'s, no judge prompt reaches the card, and every
score and unparseable row equals the simulated judge rerun on the host;
(d) phase 2's task in memory at ``temperature=0.7`` in two fresh engines:
equal texts, unlike the greedy ones, and one decode step's sampled tokens
equal to the host's argmax of the step's logits / T plus the CPU's
threefry Gumbel noise under the same key, near ties (top two within 1e-5
relative) counted and exempt.  Phase 8, streaming at scale, runs at the
end of phase 6's session (every prompt already encoded, no new weights),
chunks of 16, ``backend="device"``: (a) qwen3-4b over 48 rows spilled to
a manifest, uninterrupted, then crashed by ``ChunkCrashMiddleware`` after
chunk 1 and resumed in the same session (only chunk 2's 16 prompts reach
the engine, 16 x 36 launches of kernel 1 and one of kernel 6; metrics and
streaming state bit for bit the uninterrupted run's), then resumed again
(no engine call, no launch); (b) the same rows with
``max_inflight_chunks=2`` (texts' digests, metrics, streaming state and
engine stats bit for bit (a)'s, at most 32 rows resident); (c) 64 rows
stopped by ``with_stopping(max_examples=32, min_examples=16)`` after
chunk 1 and replayed with no engine call, and a width rule on
``exact_match`` (0 on every answer, so its half-width depends on n
alone) whose target, computed on the host with the port's
``sequential_ci``, fires after chunk 2 of 4; (d) ``run_adaptive_suite``
over qwen3-4b and mamba2-2.7b with ``BudgetConfig(total_examples=96,
min_examples=16, round_examples=16)``: every round after the seed round
runs only new chunks, the budget holds, kernel 8 launches in the Mamba2
arm, the verdicts equal ``sequential_compare`` rerun on the host, and a
replay over the same spill dirs makes no engine call and gives the same
payload.  Phase 9, the serving fabric, runs after phase 8 in sessions of
its own: two replicas of full-width qwen3-4b on the card
(``InferenceConfig(n_replicas=2)``), sharing one set of random bf16
weights (phase 2's seed) and phase 7 (a)'s tokenizer memory, over phase 7
(a)'s 16 rows: (a) ``least_loaded`` routing in memory and streaming
(``backend="device"``), bit for bit phase 7 (a)'s single-engine service
runs, both replicas dispatched; (b) streaming under a
``ServingFaultSchedule`` that crashes replica 0 at batcher step 6 and
hangs replica 1 at step 10 past a 4-pump health probe: bit for bit (a),
two restarts, no failure, both faults injected, kernel 1 launched again
for the survivors; (c) in memory with replica 0 hung for the whole run,
no probe and a 0.5 s deadline: every row served by replica 1 with (a)'s
texts, deadline expiries, hedges and cancelled losing legs, no slot held
at close.  Phase 10, the MoE family, runs after every earlier session
has closed: full-width qwen3-moe-30b-a3b (48 layers, 128 experts, top 8;
56.9 GiB of random bf16 weights from seed 0, made once and shared by every
engine of the phase, one cache alive at a time), each run_task over 16
rows, as in phases 11 and 12.  (a) ``run_task`` over phase 2's first
rows on the contiguous cache (kernels 1, 2 and 6 launched), then phase 2's gates: batch invariance, finite logits, the
step breakdowns with the expert products' share; (b) ``run_task`` over
phase 3's few-shot prompts on the f32 pool with prefix sharing (kernel 1
with ``q_offset`` > 0, kernel 3), then phase 3's ``infer_batch`` gates;
(c) on the int8 pool (kernel 4, texts non-empty, logits finite); (d)
MoE layer 0 over 478 tokens (capacity 40) against the naive
token-by-token version in f32: the routing mask and kept set equal,
tokens dropped, the output within its tolerance.  Phase 11, the qkv-bias
dense family, runs after phase 10 has freed its weights: full-width
qwen2.5-32b (64 layers, 40 / 8 heads of 128, untied vocab 152,064; 61
GiB of random bf16 weights from seed 0, the MLP leaves drawn a layer at a
time, and seeded random q/k/v biases in place of the reference's zeros,
gated to move the logits), one cache alive at a time, over 16 rows: (a)
phase 2's task and gates, (b) phase 3's few-shot task on the f32 pool
with sharing and the ``infer_batch`` gates, (c) the int8 pool.  Phase 12,
the hybrid family, runs next: full-width zamba2-7b (81 Mamba2 layers, the
shared attention and MLP block after every 6th: 13 applications and a
tail of 3; 12.3 GiB of random bf16 weights) over 16 of phase 3's few-shot
prompts on the contiguous cache, with kernel 1 launched exactly 13 times
a prompt, kernel 8 81 times and kernel 2 13 times a decode step; then
phase 4's gates (batch invariance, a reused slot, the hand-off), a paged
engine refused with the reference's error, and one shared-block
application and one Mamba2 layer at full width through the kernels
against the same layers through the plain versions.  Phase 13, the MLA
family, runs next: full-width minicpm3-4b (62 layers, 40 heads, a query
rank of 768, a KV latent of 256 and a rope key of 32 a token; 7.6 GiB of
random bf16 weights) on the contiguous compressed cache: (a) ``run_task``
over 32 of phase 2's rows, kernel 1 at (d_qk, d_v) = (96, 64) launched
exactly 62 times a prompt and kernel 2 never (the absorbed decode is
plain f32 products), then phase 2's engine gates; (b) ``run_task`` over 16
of phase 3's few-shot prompts (kernel 1 at 478 tokens, two warpgroups),
then a reused slot against a fresh engine; (c) a paged engine refused
with the reference's error; (d) one MLA layer through kernel 1 against its
plain version, and 4 decode steps after a prefill against full prefills.
Phase 1 holds kernel 1 at (96, 64), 40 heads, and kernel 7 at 1,024
tokens a side.  Phase 14, the enc-dec family, runs last: full-width
whisper-large-v3 (32 encoder and 32 decoder layers, 20 heads of 64, 1,500
frames; 2.9 GiB of random bf16 weights) through the port's
``ContinuousBatcher``, each request's (1,500, 1,280) frames in
``Request.extras``: (a) 8 QA prompts, 32 new tokens each, kernel 1 launched
exactly 96 times a prompt (the encoder's 32 self-attentions, not causal;
the decoder's 32 causal ones and 32 cross-attentions over the frames, not
causal) and kernel 2 exactly 64 times a decode step (32 over the self
rows, 32 over all 1,500 cross rows); (b) a request alone in a reused slot
and in a fresh batcher gives its tokens among 8, 4 decode steps after a
prefill against full prefills, one encoder and one decoder layer (prefill
and a decode step) through kernels 1 and 2 against their plain versions,
the breakdowns of a prefill and a decode step; (c) a paged batcher refused
with the reference's words and the local engine refusing whisper.  Phase
1 holds kernel 1 at (64, 64) causal and not, and kernel 2 at 64 over
phase 14's cross rows and main-path lengths.  Phase 15, the VLM family,
runs last: full-width paligemma-3b (18 layers, 8 heads of 256 over 1 KV
head, d_ff 16,384 with the tanh-gelu GeGLU, a tied vocab of 257,216,
token embeddings times sqrt(d_model) rounded to bf16; 4.7 GiB of random
bf16 weights) through the port's ``ContinuousBatcher``, each request's
(256, 2,048) bf16 patch embeddings (seeded, on the card, at 0.02 scale) in
``Request.extras``: (a) 8 QA prompts, 32 new tokens each, kernel 1
launched exactly 18 times a prompt (one a layer, under the prefix-LM mask
with ``prefix_len`` 256) and kernel 2 exactly 18 times a decode step; (b)
a request alone in a reused slot and in a fresh batcher gives its tokens
among 8, 4 decode steps after a prefill against full prefills, the
breakdowns of a prefill and a decode step, layer 0's prefill and one
decode step through kernels 1 and 2 against their plain versions; (c) a
paged batcher and a suffix prefill refused with the reference's words and
the local engine refusing paligemma.  Phase 1 holds kernel 1 at d = 256,
8 heads over 1 KV head, with ``prefix_len`` 256 at 268 and 512 tokens and
causal at 12, and kernel 2 at d = 256, G = 8 at phase 15's lengths; SDPA
gets K and V expanded to 8 heads and the boolean prefix-LM mask.
Phase 16, training and checkpoints, runs last and launches no kernel in
training (the training path reaches none): (a) full-width qwen3-4b with
f32 master weights made on the card (16 bytes a parameter with the
gradients and two AdamW moments, ~60 GiB), its training forward in bf16
over a 16-token prompt against the serving prefill of every prefix on a
bf16 copy of the weights (kernel 1 exactly 36 times a prefill, the copy
freed after), then 4 ``make_train_step`` steps of 8 x 64 tokens with
``remat="full"``: every loss and gradient norm finite, the last loss below
the first, the step walls, tokens/s, peak memory and the breakdown of a
further step logged; (b) reduced qwen3-4b in f32 through
``simulate_training`` with checkpoints in a temporary directory, crashed
after step 3 and resumed: bit-equal to the uninterrupted run.

Standard output: the card's name and power limit first, then log lines,
then one ``{"kernels": [...]}`` line, and last the
``{"ok": true, "device": ...}`` line.  Any failed check exits non-zero
without the last line.  Without a CUDA device, or outside a checkout, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor-core and f32
#: non-tensor-core FLOP/s, and HBM3 bytes/s
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM_BYTES_PER_S = 3.35e12

#: full-width qwen3-4b attention geometry
HEADS, KV_HEADS, HEAD_DIM = 32, 8, 128
#: phase 10's model, full-width qwen3-moe-30b-a3b, and its attention
#: geometry: 32 query heads over 4 KV heads, G = 8
MOE = "qwen3-moe-30b-a3b"
MOE_HEADS, MOE_KV_HEADS = 32, 4

#: the main path of phase 2: QA rows, rows per chunk, batcher slots, cache
#: positions per slot, new tokens per prompt, bootstrap replicates.  Phases
#: 2, 5 and 6 ran 64 rows until a host took 1,149.1 s after the build for
#: the script (NVIDIA H100 80GB HBM3, 700 W; another took 668.5 s before
#: phase 14 was added)
N_ROWS, CHUNK, N_SLOTS, MAX_LEN, MAX_TOKENS, N_BOOT = 32, 16, 16, 1024, 32, 1000
#: the QA rows behind phase 3's few-shot prompts (their longest sets phase
#: 1's suffix shape) and phase 8's longest run
QA_ROWS = 4 * CHUNK
#: a main-path prompt's length (the QA prompts render to 10-13 tokens)
PROMPT_LEN = 12
#: the depth of the later paths, so that the script stays within its time
#: limit on a slow host (an NVIDIA H100 80GB HBM3 at 700 W whose host took
#: 1,184.5 s after the build with phases 3-4 at 64 rows, phase 7 at 32 and
#: phases 10-13 at 32, where another took 915.7 s): phase 3's and 4's
#: run_tasks and phase 13 (a) run two chunks, as phase 2 does; phases 10-12
#: (three models of 7-33 B parameters) and phase 13 (b) one
HALF_ROWS = 2 * CHUNK
BIG_ROWS = CHUNK
#: phase 3: tokens per KV page, and the few-shot header's token range
PAGE_SIZE = 16
HEADER_TOKENS = (448, 480)
#: phase 1's prefill shapes (Sq, Sk, q_offset); the last is phase 3's suffix
#: prefill after a prefix-cache hit (478 tokens, 464 shared; FewShot checks)
FLASH_SHAPES = ((PROMPT_LEN, PROMPT_LEN, 0), (37, 37, 0), (512, 512, 0),
                (2048, 2048, 0), (512, 2048, 1536), (14, 478, 464))
#: the G = 8 prefill shapes: phase 10's QA prompts, its few-shot prompt
#: prefilled whole (478 tokens) and the G = 4 rows' 512, both with two
#: consumer warpgroups, and its suffix prefill
MOE_FLASH_SHAPES = (FLASH_SHAPES[0], (478, 478, 0), FLASH_SHAPES[2], FLASH_SHAPES[-1])
#: full-width mamba2-2.7b SSD geometry (phase 4's): heads, head_dim, state
#: size, groups, chunk
SSM_HEADS, SSM_HEAD_DIM, SSM_STATE, SSM_GROUPS, SSM_CHUNK = 80, 64, 128, 1, 256
#: phase 11's model, full-width qwen2.5-32b, and its attention geometry:
#: 40 query heads over 8 KV heads, G = 5
QWEN25 = "qwen2.5-32b"
QWEN25_HEADS, QWEN25_KV_HEADS = 40, 8
#: phase 12's model, full-width zamba2-7b: its shared block's attention (32
#: heads of 112, G = 1) and its SSD geometry (112 heads of 64, state 64)
ZAMBA = "zamba2-7b"
ZAMBA_HEADS, ZAMBA_HEAD_DIM = 32, 112
ZAMBA_SSM_HEADS, ZAMBA_SSM_STATE = 112, 64
#: the G = 5 and d = 112 prefill shapes: phase 11's QA prompts, its
#: few-shot prompt prefilled whole (two consumer warpgroups) and its suffix
#: prefill; phase 12's QA-length and few-shot prompts
QWEN25_FLASH_SHAPES = (FLASH_SHAPES[0], (478, 478, 0), FLASH_SHAPES[-1])
ZAMBA_FLASH_SHAPES = (FLASH_SHAPES[0], (478, 478, 0))
#: phase 13's model, full-width minicpm3-4b, and its MLA prefill geometry:
#: 40 heads (G = 1), Q and K of nope 64 + rope 32, V of 64; its QA-length
#: and few-shot prompts (two consumer warpgroups)
MINICPM = "minicpm3-4b"
MLA_HEADS, MLA_QK_DIM, MLA_V_DIM = 40, 96, 64
MLA_FLASH_SHAPES = (FLASH_SHAPES[0], (478, 478, 0))
#: phase 14's model, full-width whisper-large-v3: 20 heads of 64 over 20 KV
#: heads (G = 1), 1,500 encoder frames; its prefill rows (Sq, Sk, causal):
#: the encoder over the frames, the cross-attention of a QA prompt over
#: them, the decoder's causal prompt
WHISPER = "whisper-large-v3"
WHISPER_HEADS, WHISPER_HEAD_DIM, WHISPER_FRAMES = 20, 64, 1500
WHISPER_FLASH_SHAPES = ((WHISPER_FRAMES, WHISPER_FRAMES, False),
                        (PROMPT_LEN, WHISPER_FRAMES, False), (PROMPT_LEN, PROMPT_LEN, True))
#: phase 15's model, full-width paligemma-3b: 8 heads of 256 over 1 KV head
#: (G = 8), 256 patch positions ahead of each prompt; its cache rows a slot;
#: its prefill rows (Sq = Sk, prefix_len): a QA prompt after the patches,
#: 512 tokens under the same mask, a 12-token causal prompt
PALIGEMMA = "paligemma-3b"
PALI_HEADS, PALI_KV_HEADS, PALI_HEAD_DIM, PALI_PREFIX = 8, 1, 256, 256
PALI_MAX_LEN = 512
PALI_FLASH_SHAPES = ((PALI_PREFIX + PROMPT_LEN, PALI_PREFIX), (512, PALI_PREFIX),
                     (PROMPT_LEN, 0))
#: phase 5: BERTScore's default max_len and the hash embedder's width, the
#: seven metrics (name, type), and the statistics API's sample size; phase
#: 1 also holds kernel 7 at ``max_len = BERT_LONG``, past its old limit of 512
BERT_LEN, BERT_DIM, BERT_LONG = 64, 256, 1024
METRICS = (("exact_match", "lexical"), ("contains", "lexical"),
           ("token_f1", "lexical"), ("bleu", "lexical"), ("rouge_l", "lexical"),
           ("embedding_similarity", "semantic"), ("bertscore", "semantic"))
N_SCORES = 1_000_000


class CheckFailed(RuntimeError):
    pass


def log(msg: str) -> None:
    print(f"# {msg}", flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


#: Poisson-bootstrap draw work: the least that any version of kernels 5 and
#: 6 must do for one (example, replicate) draw.  The counter mixer is h = K
#: ^ pos * C2, with the replicate's key K = boot * C1 ^ seed, then h ^= h >>
#: 16, h *= C3, h ^= h >> 13, h *= C4, h ^= h >> 16, and the weight counts
#: the thresholds T_k <= h >> 8 (that is h >= T_k << 8: no shift).  With K
#: hoisted out of the row loop and pk = pos * C2 a running add, and since a
#: shift distributes over xor, the first pair is K' ^ pk ^ (pk >> 16) with
#: K' = K ^ (K >> 16) hoisted too: one shift and one 3-input xor.  A draw
#: is then 1 add + 3 shifts + 3 xors + 2 multiplies + 7 compares = 16
#: instructions; forming the count from the 7 compares is not counted, so
#: the bound errs low.  The add and the shifts can issue on the FMA pipe
#: beside the multiplies (IMAD.IADD; IMAD.HI.U32, x >> s = hi32(x * 2^(32 -
#: s))); the 3 xors and the 7 compares run only on the integer ALU, at 64
#: lanes a clock an SM on compute capability 9.0 (CUDA C++ Programming
#: Guide, arithmetic instruction throughput).  Every instruction takes an
#: issue slot: 4 schedulers x 32 lanes = 128 a clock an SM.
DRAW_ALU_OPS = 10
DRAW_INSTRUCTIONS = 16
ALU_LANES_PER_SM = 64
ISSUE_LANES_PER_SM = 128


def sm_clocks_per_s(torch) -> float:
    """SMs x the maximum SM clock that ``nvidia-smi`` reports, in Hz: the
    operations a second of one lane in every SM."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    return torch.cuda.get_device_properties(0).multi_processor_count * mhz * 1e6


def draw_bound(torch, draws: float, alu_extra: float, issue_extra: float,
               flops: float, nbytes: float) -> tuple[float, str]:
    """Bound (ms) of a bootstrap kernel: the largest of its ALU-only work
    (``DRAW_ALU_OPS`` a draw plus ``alu_extra``) at 64 lanes a clock an SM,
    all its instructions (``DRAW_INSTRUCTIONS`` a draw plus ``alu_extra``
    and ``issue_extra``) at 128 issue lanes a clock an SM, its f32 FLOPs at
    the f32 peak and its bytes at the memory rate."""
    rate = sm_clocks_per_s(torch)
    t_alu = (draws * DRAW_ALU_OPS + alu_extra) / (rate * ALU_LANES_PER_SM)
    t_issue = ((draws * DRAW_INSTRUCTIONS + alu_extra + issue_extra)
               / (rate * ISSUE_LANES_PER_SM))
    t_ops = max(t_alu, t_issue) * 1e3
    b_ms, b_by = bound(flops, PEAK_F32, nbytes)
    return (t_ops, "operations") if t_ops > b_ms else (b_ms, b_by)


def bound(flops: float, peak: float, nbytes: float) -> tuple[float, str]:
    """Least time (ms) the card could take: the larger of operations over
    the peak rate and bytes over the memory rate, and which one it is."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rowwise(torch, out, ref, rtol: float, row_frac: float) -> tuple[float, float]:
    """Elementwise |out - ref| <= rtol*|ref| + row_frac*max|ref over the
    row| (rows along the last axis).  Returns (max abs error, worst ratio of
    error to allowance); a ratio above 1 fails."""
    o, r = out.float(), ref.float()
    require(bool(torch.isfinite(o).all()), "kernel output is not finite")
    allow = rtol * r.abs() + row_frac * r.abs().amax(dim=-1, keepdim=True)
    err = (o - r).abs()
    ratio = float((err / allow.clamp_min(1e-30)).max())
    return float(err.max()), ratio


# -- phase 1: kernels against their plain versions ------------------------------


def flash_cases(torch, fs):
    from repro_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_ref,
    )

    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(s, h, d=HEAD_DIM):
        return torch.randn((1, s, h, d), generator=g, device="cuda",
                           dtype=torch.float32).to(torch.bfloat16)

    out = []
    cases = (
            [(shape, HEADS, KV_HEADS, HEAD_DIM, HEAD_DIM, True) for shape in FLASH_SHAPES]
            + [(shape, MOE_HEADS, MOE_KV_HEADS, HEAD_DIM, HEAD_DIM, True)
               for shape in MOE_FLASH_SHAPES]
            + [(shape, QWEN25_HEADS, QWEN25_KV_HEADS, HEAD_DIM, HEAD_DIM, True)
               for shape in QWEN25_FLASH_SHAPES]
            + [(shape, ZAMBA_HEADS, ZAMBA_HEADS, ZAMBA_HEAD_DIM, ZAMBA_HEAD_DIM, True)
               for shape in ZAMBA_FLASH_SHAPES]
            + [(shape, MLA_HEADS, MLA_HEADS, MLA_QK_DIM, MLA_V_DIM, True)
               for shape in MLA_FLASH_SHAPES]
            + [((sq, sk, 0), WHISPER_HEADS, WHISPER_HEADS, WHISPER_HEAD_DIM,
                WHISPER_HEAD_DIM, causal) for sq, sk, causal in WHISPER_FLASH_SHAPES])
    # (the rows above without a prefix) and phase 15's under the prefix-LM mask
    cases = [(*c, 0) for c in cases] + [
        ((sq, sq, 0), PALI_HEADS, PALI_KV_HEADS, PALI_HEAD_DIM, PALI_HEAD_DIM, True, pre)
        for sq, pre in PALI_FLASH_SHAPES]
    for (sq, sk, off), heads, kvh, d, dv, causal, pre in cases:
        q, k, v = rnd(sq, heads, d), rnd(sk, kvh, d), rnd(sk, kvh, dv)
        kw = {"q_offset": off, "causal": causal, "prefix_len": pre}
        got = flash_attention(q, k, v, **kw)
        ref = flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        # P is rounded to bf16 unnormalised in the kernel and normalised in
        # the plain version, and both round the output to bf16: 2^-7 of the
        # value plus 1% of the row's largest output.  A 32-key tile dropped
        # from a 2,048-key row moves the output by ~10x that allowance.
        err, ratio = rowwise(torch, got, ref, 2**-7, 1e-2)
        width = f"d={d}" if d == dv else f"d_qk={d} d_v={dv}"
        shape = (f"B=1 H={heads} K={kvh} {width} Sq={sq} Sk={sk} "
                 + (f"q_offset={off}" if causal else "not causal")
                 + (f" prefix_len={pre}" if pre else ""))
        require(ratio <= 1.0, f"flash_attention {shape}: error/allowance {ratio:.3g}")
        # 2 d_qk FLOPs a visible (query head, key) pair for Q K^T and 2 d_v
        # for P V (a causal row sees up to max(its position, prefix - 1));
        # Q and K read, V read and O written once, bf16
        pairs = (sum(min(sk, max(off + i, pre - 1) + 1) for i in range(sq)) if causal
                 else sq * sk)
        nbytes = 2 * (d * (sq * heads + sk * kvh) + dv * (sk * kvh + sq * heads))
        b_ms, b_by = bound(2 * (d + dv) * pairs * heads, PEAK_BF16, nbytes)
        kx, vx = (t.repeat_interleave(heads // kvh, dim=2) for t in (k, v))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, kx, vx))
        # no mask tensor where every key is visible; the prefix-LM mask as
        # the reference's make_causal_mask builds it
        q_pos = torch.arange(sq, device="cuda")[:, None] + off
        k_pos = torch.arange(sk, device="cuda")[None, :]
        mask = ((q_pos >= k_pos) | ((q_pos < pre) & (k_pos < pre))) if causal else None
        # SDPA takes a V width other than the Q/K width (E != Ev)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        out.append({
            "name": "flash_attention",
            "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/flash_attention.py:93",
            "shape": shape,
            "max_abs_err": err,
            "ms": time_ms(torch, lambda: flash_attention(q, k, v, **kw)),
            "device_ms": device_profile(torch, lambda: flash_attention(q, k, v, **kw), 1),
            "plain_ms": time_ms(torch, lambda: flash_attention_ref(q, k, v, **kw),
                                iters=5),
            "library_ms": time_ms(torch, lambda: sdpa(qt, kt, vt, attn_mask=mask)),
            "bound_ms": b_ms,
            "bound_by": b_by,
        })
        is_causal = ""
        if sq == sk and causal and not pre:
            causal_ms = time_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True))
            is_causal = f", sdpa is_causal (no mask tensor) {causal_ms:.4g} ms"
        log(f"flash_attention {shape}: err {err:.3g} (ratio {ratio:.3g}) "
            f"{out[-1]['ms']:.4g} ms (device {out[-1]['device_ms']:.4g} ms), plain "
            f"{out[-1]['plain_ms']:.4g} ms, sdpa {out[-1]['library_ms']:.4g} ms"
            f"{is_causal}, bound {b_ms:.4g} ms ({b_by})")

    # a row's bits do not depend on its tile, on Sq or on q_offset: the last
    # rows of phase 3's (and phase 10's, and 11's) full prefill against the
    # suffix prefill after a hit
    for heads, kvh in ((HEADS, KV_HEADS), (MOE_HEADS, MOE_KV_HEADS),
                       (QWEN25_HEADS, QWEN25_KV_HEADS)):
        q, k, v = rnd(fs.prompt_len, heads), rnd(fs.prompt_len, kvh), \
            rnd(fs.prompt_len, kvh)
        full = flash_attention(q, k, v)
        tail = flash_attention(q[:, fs.shared:], k, v, q_offset=fs.shared)
        torch.cuda.synchronize()
        require(bool(torch.equal(full[:, fs.shared:], tail)),
                f"flash_attention H={heads} K={kvh}: the last "
                f"{fs.prompt_len - fs.shared} rows of a {fs.prompt_len}-token "
                f"prefill differ from the suffix prefill")
        log(f"flash_attention H={heads} K={kvh}: rows {fs.shared}..{fs.prompt_len - 1} "
            f"bit-equal between the full {fs.prompt_len}-token prefill and the "
            f"suffix prefill (q_offset {fs.shared})")

    # the wrapper's host time per call at phase 2's shape, the device left
    # to drain: what a prefill layer pays on the host
    q, k, v = rnd(PROMPT_LEN, HEADS), rnd(PROMPT_LEN, KV_HEADS), \
        rnd(PROMPT_LEN, KV_HEADS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(500):
        flash_attention(q, k, v)
    host_us = (time.perf_counter() - t0) / 500 * 1e6
    torch.cuda.synchronize()
    log(f"flash_attention wrapper at Sq=Sk={PROMPT_LEN}: {host_us:.2f} us of host "
        f"time per call")
    # kernel 1 with one and two consumer warpgroups (+ 1 producer warp)
    kernel_limits("repro_flash_kernel_info",
                  {1: "flash_attention, 1 consumer warpgroup",
                   2: "flash_attention, 2 consumer warpgroups",
                   3: "flash_attention d=112, 1 consumer warpgroup",
                   4: "flash_attention d=112, 2 consumer warpgroups",
                   5: "flash_attention d_qk=96 d_v=64, 1 consumer warpgroup",
                   6: "flash_attention d_qk=96 d_v=64, 2 consumer warpgroups",
                   7: "flash_attention d=64, 1 consumer warpgroup",
                   8: "flash_attention d=64, 2 consumer warpgroups",
                   9: "flash_attention d=256, 1 consumer warpgroup (every Sq)"})
    return out


def decode_cases(torch) -> list[dict]:
    """Kernel 2 over phase 2's cache (16 slots of 1,024 f32 rows) at ragged
    lengths 1..1,024 and at the main path's: a 10-13-token prompt plus up
    to 32 new tokens, 11..45; and at phase 14's head width of 64 over its
    cross cache (16 slots of 1,500 rows, every length 1,500); and at phase
    15's width of 256, G = 8, over its cache (16 slots of 512 rows) at its
    lengths: 256 patch rows, a 12-token prompt and up to 32 new tokens."""
    g = torch.Generator(device="cuda").manual_seed(1)
    ragged = torch.randint(2, MAX_LEN, (N_SLOTS,), generator=g, device="cuda",
                           dtype=torch.int32)
    ragged[0], ragged[1] = 1, MAX_LEN
    lo, hi = PROMPT_LEN - 1, PROMPT_LEN + 1 + MAX_TOKENS
    main = (lo + (hi - lo) * torch.arange(N_SLOTS, device="cuda") // (N_SLOTS - 1))
    main = main.to(torch.int32)
    # phase 12's few-shot prompts (478 tokens) plus up to 32 new tokens
    few = (479 + 2 * torch.arange(N_SLOTS, device="cuda")).to(torch.int32)
    # phase 14's cross decode (every slot over all 1,500 encoder rows) and
    # its self decode (a QA prompt plus up to 32 new tokens)
    frames = torch.full((N_SLOTS,), WHISPER_FRAMES, dtype=torch.int32, device="cuda")
    # phase 15's decode: 256 patch rows, a 12-token prompt, up to 32 new tokens
    p_lo, p_hi = PALI_PREFIX + PROMPT_LEN, PALI_PREFIX + PROMPT_LEN + MAX_TOKENS
    pali = (p_lo + (p_hi - p_lo) * torch.arange(N_SLOTS, device="cuda")
            // (N_SLOTS - 1)).to(torch.int32)
    out = [decode_case(torch, g, ragged, f"lengths 1..{MAX_LEN}"),
           decode_case(torch, g, main, f"main-path lengths {lo}..{hi} (phase 2)"),
           decode_case(torch, g, main, f"main-path lengths {lo}..{hi} (phase 10)",
                       MOE_HEADS, MOE_KV_HEADS),
           decode_case(torch, g, main, f"main-path lengths {lo}..{hi} (phase 11)",
                       QWEN25_HEADS, QWEN25_KV_HEADS),
           decode_case(torch, g, main, f"lengths {lo}..{hi}", ZAMBA_HEADS,
                       ZAMBA_HEADS, ZAMBA_HEAD_DIM),
           decode_case(torch, g, few, "main-path lengths 479..509 (phase 12)",
                       ZAMBA_HEADS, ZAMBA_HEADS, ZAMBA_HEAD_DIM),
           decode_case(torch, g, frames, f"cross lengths all {WHISPER_FRAMES} "
                       "(phase 14)", WHISPER_HEADS, WHISPER_HEADS, WHISPER_HEAD_DIM,
                       s=WHISPER_FRAMES),
           decode_case(torch, g, main, f"main-path lengths {lo}..{hi} (phase 14)",
                       WHISPER_HEADS, WHISPER_HEADS, WHISPER_HEAD_DIM),
           decode_case(torch, g, pali, f"main-path lengths {p_lo}..{p_hi} (phase 15)",
                       PALI_HEADS, PALI_KV_HEADS, PALI_HEAD_DIM, s=PALI_MAX_LEN)]
    # kernels 2 and 3 are one span-split template, six instantiations
    kernel_limits("repro_decode_kernel_info",
                  {0: "decode_attention split, G <= 4",
                   1: "decode_attention split, G <= 8",
                   2: "paged_decode_attention split, G <= 4",
                   3: "paged_decode_attention split, G <= 8",
                   4: "decode_attention split d=112, G <= 4",
                   5: "decode_attention split d=112, G <= 8",
                   6: "decode_attention split d=64, G <= 4",
                   7: "decode_attention split d=64, G <= 8",
                   8: "decode_attention split d=256, G <= 4",
                   9: "decode_attention split d=256, G <= 8"})
    return out


def device_profile(torch, fn, kernels: int, calls: int = 10,
                   tries: int = 6) -> float:
    """Device time (ms) of one call of ``fn``, every kernel it launches
    summed, from a ``torch.profiler`` trace of ``calls`` calls: the kernels
    alone, without the host time that CUDA events around a loop of short
    calls also measure.  ``kernels`` is the device kernels one call
    launches.

    The profiler now and then drops records, and sometimes a whole trace
    comes back empty.  A trace that holds another count is taken again, a
    moment later, up to ``tries`` times.  If none is whole, the call's time
    is the sum over kernel names of each name's mean record time, over every
    record of every trace, times its launches a call (the most records of
    that name in one trace over ``calls``, rounded); that holds only where
    those launches add up to ``kernels``, and otherwise the profile fails.
    Where every trace came back empty, the profiler saw no device time at
    all, and the time is the median of CUDA events around single calls on
    an idle stream: the host's launch time is then in it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    counts = []
    by_name: dict[str, list[float]] = {}
    most: dict[str, int] = {}
    PROFILE_TRACES["profiles"] += 1
    for attempt in range(tries):
        if attempt:
            time.sleep(0.5)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        records = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        if len(records) == kernels * calls:
            return sum(t for _, t in records) / 1e3 / calls
        counts.append(len(records))
        trace: dict[str, int] = {}
        for name, t in records:
            by_name.setdefault(name, []).append(t)
            trace[name] = trace.get(name, 0) + 1
        for name, n in trace.items():
            most[name] = max(most.get(name, 0), n)
        PROFILE_TRACES["retakes"] += 1
        log(f"device profile: a trace of {calls} calls held {len(records)} device "
            f"records, not {kernels * calls}; taken again "
            f"({PROFILE_TRACES['retakes']} retake(s) so far)")
    per_call = {name: round(n / calls) for name, n in most.items()}
    if by_name and sum(per_call.values()) == kernels and all(per_call.values()):
        PROFILE_TRACES["estimated"] += 1
        ms = sum(per_call[name] * sum(ts) / len(ts)
                 for name, ts in by_name.items()) / 1e3
        log(f"device profile: no trace of {tries} was whole ({counts} records); "
            f"{ms:.4g} ms a call from each kernel's mean record time over "
            f"{sum(len(ts) for ts in by_name.values())} records "
            f"({', '.join(f'{n} x {name[:40]}' for name, n in per_call.items())})")
        return ms
    if not by_name:
        PROFILE_TRACES["events"] += 1
        times = []
        for _ in range(calls):
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        ms = sorted(times)[calls // 2]
        log(f"device profile: every one of {tries} traces was empty; {ms:.4g} ms a "
            f"call from CUDA events around single calls (host launch time included)")
        return ms
    raise CheckFailed(f"device profile: {counts} device records in {tries} traces "
                      f"of {calls} calls, not {kernels * calls} each")


#: device profiles taken, traces taken again because they were short of a
#: device record, profiles read from per-kernel means because no trace was
#: whole, and from CUDA events because every trace was empty (logged at the
#: end of phase 1)
PROFILE_TRACES = {"profiles": 0, "retakes": 0, "estimated": 0, "events": 0}


def kernel_limits(lib_fn: str, names: dict[int, str]) -> None:
    """Registers and local bytes a thread (0: no spills), shared memory a
    block and resident blocks an SM of each device kernel behind an entry
    point (``names``: the info entry's index -> a label), as the runtime
    reports them; fails on any spill."""
    import ctypes

    from repro_torch.kernels import _cuda

    for which, name in names.items():
        vals = [ctypes.c_int() for _ in range(4)]
        _cuda.check(getattr(_cuda.library(), lib_fn)(
            which, *(ctypes.byref(v) for v in vals)), lib_fn)
        regs, local, smem, blocks = (v.value for v in vals)
        log(f"{name}: {regs} registers a thread, {local} local bytes a thread, "
            f"{smem} bytes of shared memory a block, {blocks} block(s) an SM")
        require(local == 0, f"{name} spills: {local} local bytes a thread")


def decode_case(torch, g, lens, label: str, heads: int = HEADS,
                kvh: int = KV_HEADS, d: int = HEAD_DIM, s: int = MAX_LEN) -> dict:
    from repro_torch.kernels.decode_attention import (
        decode_attention,
        decode_attention_ref,
    )

    b = N_SLOTS
    q = torch.randn((b, 1, heads, d), generator=g, device="cuda").to(
        torch.bfloat16)
    kc = torch.randn((b, s, kvh, d), generator=g, device="cuda")
    vc = torch.randn((b, s, kvh, d), generator=g, device="cuda")
    got = decode_attention(q, kc, vc, lens)
    ref = decode_attention_ref(q, kc, vc, lens)
    torch.cuda.synchronize()
    # both sides are f32 until the final bf16 rounding of the output
    err, ratio = rowwise(torch, got, ref, 2**-7, 1e-3)
    shape = (f"B={b} H={heads} K={kvh} d={d} S={s} f32 cache, "
             f"{label}")
    require(ratio <= 1.0, f"decode_attention {shape}: error/allowance {ratio:.3g}")
    n_rows = int(lens.sum())
    nbytes = 2 * b * heads * d * 2 + n_rows * kvh * d * 4 * 2 + 4 * b
    b_ms, b_by = bound(4 * d * n_rows * heads, PEAK_BF16, nbytes)
    qt = q.float().transpose(1, 2)
    kt, vt = (t.transpose(1, 2).repeat_interleave(heads // kvh, dim=1)
              for t in (kc, vc))
    mask = (torch.arange(s, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    entry = {
        "name": "decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/decode_attention.py:82",
        "shape": shape,
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: decode_attention(q, kc, vc, lens)),
        "plain_ms": time_ms(torch, lambda: decode_attention_ref(q, kc, vc, lens)),
        "library_ms": time_ms(torch, lambda: sdpa(qt, kt, vt, attn_mask=mask)),
        "device_ms": device_profile(
            torch, lambda: decode_attention(q, kc, vc, lens), 1),
        "bound_ms": b_ms,
        "bound_by": b_by,
    }
    log(f"decode_attention {shape}: err {err:.3g} (ratio {ratio:.3g}) "
        f"{entry['ms']:.4g} ms (device {entry['device_ms']:.4g} ms), plain "
        f"{entry['plain_ms']:.4g} ms, "
        f"sdpa {entry['library_ms']:.4g} ms, bound {b_ms:.4g} ms ({b_by})")
    return entry



def paged_pool(torch, g, b: int, n_p: int, n_shared: int, kvh: int):
    """Phase 3's pool: b * n_p + b pages (the batcher's default) and the
    trash page, f32 (P, ps, K, d); tables whose first n_shared entries
    alias pages 0 .. n_shared - 1 in every sequence and whose other entries
    are shuffled private pages."""
    n_pool = b * n_p + b + 1
    shape = (n_pool, PAGE_SIZE, kvh, HEAD_DIM)
    k = torch.randn(shape, generator=g, device="cuda")
    v = torch.randn(shape, generator=g, device="cuda")
    private = torch.randperm(n_pool - n_shared, generator=g, device="cuda") + n_shared
    tables = private[: b * (n_p - n_shared)].view(b, -1)
    shared = torch.arange(n_shared, device="cuda").expand(b, -1)
    return k, v, torch.cat([shared, tables], 1).to(torch.int32).contiguous()


def pad_tables(torch, tables, lens):
    """Entries past ceil(length / ps) become 0, the padding convention."""
    used = (lens + PAGE_SIZE - 1) // PAGE_SIZE
    pad = torch.arange(tables.shape[1], device="cuda")[None, :] >= used[:, None]
    return tables.masked_fill(pad, 0)


def paged_bound(torch, tables, lens, heads: int, row_bytes: int, page_bytes: int,
                skip_last: bool, extra_bytes: int) -> tuple[float, str]:
    """Least time for one paged decode call: the distinct pool rows its
    sequences read (an aliased row once; the row a fresh row replaces not
    at all) at ``row_bytes`` for K and V together, ``page_bytes`` of scales
    per distinct page, q and out in bf16, tables, lengths and
    ``extra_bytes``, at 3.35 TB/s; 4 d FLOPs per (query head, visible key)
    pair at the bf16 peak."""
    b, n_p = tables.shape
    pos = torch.arange(n_p * PAGE_SIZE, device="cuda")
    need = pos[None, :] < (lens[:, None] - (1 if skip_last else 0))
    page = tables.long().gather(1, (pos // PAGE_SIZE).expand(b, -1))
    rows = (page * PAGE_SIZE + pos % PAGE_SIZE)[need]
    n_rows = int(rows.unique().numel())
    n_pages = int(page[need].unique().numel())
    nbytes = (n_rows * row_bytes + n_pages * page_bytes
              + 2 * b * heads * HEAD_DIM * 2 + 4 * (b * n_p + b) + extra_bytes)
    log(f"  bound inputs: {int(lens.sum())} visible keys, {n_rows} distinct "
        f"pool rows in {n_pages} pages, {nbytes} bytes")
    return bound(4 * HEAD_DIM * heads * int(lens.sum()), PEAK_BF16, nbytes)


def paged_cases(torch, fs) -> list[dict]:
    """Kernels 3 and 4 at phase 3's geometry (16 sequences, 64 pages of 16
    rows, a pool of 1,041 pages, the shared header's pages aliased in every
    table): at G = 4 at ragged lengths 1 .. 1,024 and at the main path's
    lengths, at G = 8 (phase 10's heads) at the main path's lengths."""
    out = [*paged_geometry(torch, fs, HEADS, KV_HEADS, ragged_too=True),
           *paged_geometry(torch, fs, MOE_HEADS, MOE_KV_HEADS, ragged_too=False),
           *paged_geometry(torch, fs, QWEN25_HEADS, QWEN25_KV_HEADS,
                           ragged_too=False)]
    kernel_limits("repro_quant_paged_kernel_info",
                  {0: "quant_paged_decode_attention split, G <= 4",
                   1: "quant_paged_decode_attention split, G <= 8",
                   2: "quant_paged_decode_attention combine"})
    return out


def paged_geometry(torch, fs, heads: int, kvh: int, ragged_too: bool) -> list[dict]:
    from repro_torch.kernels.decode_attention import (
        decode_attention,
        paged_decode_attention,
        paged_decode_attention_ref,
        quant_paged_decode_attention,
        quant_paged_decode_attention_ref,
        quantize_pages,
    )

    b, n_p = N_SLOTS, MAX_LEN // PAGE_SIZE
    n_shared = fs.shared // PAGE_SIZE
    g = torch.Generator(device="cuda").manual_seed(3)
    k, v, full_tables = paged_pool(torch, g, b, n_p, n_shared, kvh)
    kq, ks = quantize_pages(k)
    vq, vs = quantize_pages(v)
    q = torch.randn((b, 1, heads, HEAD_DIM), generator=g, device="cuda").to(
        torch.bfloat16)
    k_new = torch.randn((b, kvh, HEAD_DIM), generator=g, device="cuda")
    v_new = torch.randn((b, kvh, HEAD_DIM), generator=g, device="cuda")
    ragged = torch.randint(1, MAX_LEN + 1, (b,), generator=g, device="cuda")
    ragged[:6] = torch.tensor([1, MAX_LEN, PAGE_SIZE, fs.shared, 512, 17])
    main = fs.prompt_len + 1 + 2 * torch.arange(b, device="cuda")
    phase = {(HEADS, KV_HEADS): "phase 3", (MOE_HEADS, MOE_KV_HEADS): "phase 10",
             (QWEN25_HEADS, QWEN25_KV_HEADS): "phase 11"}[heads, kvh]
    out = []
    cases = [(f"main-path lengths {int(main[0])}..{int(main[-1])} ({phase})", main)]
    if ragged_too:
        cases.insert(0, ("ragged lengths 1..1024", ragged))
    for label, lens in cases:
        lens = lens.to(torch.int32)
        tables = pad_tables(torch, full_tables, lens)
        shape = (f"B={b} H={heads} K={kvh} d={HEAD_DIM} ps={PAGE_SIZE} "
                 f"nP={n_p} pool={k.shape[0]} pages, first {n_shared} aliased, {label}")

        got = paged_decode_attention(q, k, v, tables, lens)
        ref = paged_decode_attention_ref(q, k, v, tables, lens)
        contiguous = decode_attention(q, k[tables.long()].flatten(1, 2),
                                      v[tables.long()].flatten(1, 2), lens)
        torch.cuda.synchronize()
        # both sides f32 until the final bf16 rounding of the output, as decode
        err, ratio = rowwise(torch, got, ref, 2**-7, 1e-3)
        require(ratio <= 1.0,
                f"paged_decode_attention {shape}: error/allowance {ratio:.3g}")
        require(bool(torch.equal(got, contiguous)),
                f"paged_decode_attention {shape}: not bit-equal to decode_attention")
        b_ms, b_by = paged_bound(torch, tables, lens, heads, 2 * kvh * HEAD_DIM * 4,
                                 0, False, 0)
        kc, vc = (t[tables.long()].flatten(1, 2) for t in (k, v))
        entry = {
            "name": "paged_decode_attention",
            "route": "cuda",
            "source": "src/repro_torch/csrc/paged_decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention/paged.py:86",
            "shape": shape,
            "max_abs_err": err,
            "ms": time_ms(torch, lambda: paged_decode_attention(q, k, v, tables, lens)),
            "plain_ms": time_ms(
                torch, lambda: paged_decode_attention_ref(q, k, v, tables, lens)),
            "library_ms": None,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "device_ms": device_profile(
                torch, lambda: paged_decode_attention(q, k, v, tables, lens), 1),
        }
        contiguous_ms = time_ms(torch, lambda: decode_attention(q, kc, vc, lens))
        qt = q.float().transpose(1, 2)
        kt, vt = (t.transpose(1, 2).repeat_interleave(heads // kvh, dim=1)
                  for t in (kc, vc))
        mask = (torch.arange(MAX_LEN, device="cuda")[None, :]
                < lens[:, None])[:, None, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        sdpa_ms = time_ms(torch, lambda: sdpa(qt, kt, vt, attn_mask=mask))
        out.append(entry)
        log(f"paged_decode_attention {shape}: err {err:.3g} (ratio {ratio:.3g}), "
            f"bit-equal to decode_attention; {entry['ms']:.4g} ms (device "
            f"{entry['device_ms']:.4g} ms), plain "
            f"{entry['plain_ms']:.4g} ms, bound {b_ms:.4g} ms ({b_by}); "
            f"decode_attention on the same rows gathered beforehand "
            f"{contiguous_ms:.4g} ms, SDPA on them gathered and expanded "
            f"beforehand {sdpa_ms:.4g} ms")

        rows = (k_new, v_new, lens - 1)
        errs = []
        for r in (None, rows):
            got = quant_paged_decode_attention(q, kq, vq, ks, vs, tables, lens, r)
            ref = quant_paged_decode_attention_ref(q, kq, vq, ks, vs, tables, lens, r)
            torch.cuda.synchronize()
            # the same int8 * scale rows in f32 on both sides, as above
            errs.append(rowwise(torch, got, ref, 2**-7, 1e-3))
            require(errs[-1][1] <= 1.0, f"quant_paged_decode_attention {shape} "
                    f"fresh rows {r is not None}: error/allowance {errs[-1][1]:.3g}")
        b_ms, b_by = paged_bound(torch, tables, lens, heads, 2 * kvh * HEAD_DIM,
                                 2 * 4 * kvh, True,
                                 2 * b * kvh * HEAD_DIM * 4 + 4 * b)
        entry = {
            "name": "quant_paged_decode_attention",
            "route": "cuda",
            "source": "src/repro_torch/csrc/quant_paged_decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention/paged_quant.py:90",
            "shape": shape + ", int8 pool, fresh rows (the main path's form)",
            "max_abs_err": max(e for e, _ in errs),
            "ms": time_ms(torch, lambda: quant_paged_decode_attention(
                q, kq, vq, ks, vs, tables, lens, rows)),
            "plain_ms": time_ms(torch, lambda: quant_paged_decode_attention_ref(
                q, kq, vq, ks, vs, tables, lens, rows)),
            "library_ms": None,
            "bound_ms": b_ms,
            "bound_by": b_by,
        }
        # two device kernels a call: the span split, then the combine
        entry["device_ms"] = device_profile(torch, lambda: quant_paged_decode_attention(
            q, kq, vq, ks, vs, tables, lens, rows), 2)
        plain_form_ms = time_ms(torch, lambda: quant_paged_decode_attention(
            q, kq, vq, ks, vs, tables, lens))
        out.append(entry)
        log(f"quant_paged_decode_attention {entry['shape']}: err "
            f"{errs[0][0]:.3g} / {errs[1][0]:.3g} (ratio {errs[0][1]:.3g} / "
            f"{errs[1][1]:.3g}) without / with fresh rows; {entry['ms']:.4g} ms "
            f"(device {entry['device_ms']:.4g} ms, split and combine; "
            f"{plain_form_ms:.4g} ms without fresh rows), plain "
            f"{entry['plain_ms']:.4g} ms, bound {b_ms:.4g} ms ({b_by})")
    return out


def bootstrap_case(torch, n: int, m: int, n_boot: int, starts: tuple[int, ...],
                   seed: int, plain_iters: int):
    """One (n, m) score matrix per start, each held against the plain
    version; the first start is timed."""
    from repro_torch.kernels.bootstrap import (
        bootstrap_partials,
        bootstrap_partials_ref,
    )

    g = torch.Generator(device="cuda").manual_seed(2 + n)
    xs = []
    errs = []
    for start in starts:
        x = torch.rand((n, m), generator=g, device="cuda")
        x[:, 0] = (x[:, 0] > 0.5).float()
        if m > 2:
            x[::13, 2] = float("nan")
        got = bootstrap_partials(x, seed, start, n_boot=n_boot)
        ref = bootstrap_partials_ref(x, seed, start, n_boot=n_boot)
        torch.cuda.synchronize()
        # identical weights, f32 sums of n terms in two fixed orders: 1e-4 of
        # the value; one dropped 64-row tile at n = 100,000 moves a sum by
        # ~6e-4 of it, and the sum w gate below catches any dropped row
        errs += [rowwise(torch, a, r, 1e-4, 1e-6) for a, r in zip(got, ref)]
        require(bool(torch.equal(got[1], ref[1])),
                f"bootstrap_partials n={n} start={start}: sum w differs")
        xs.append(x)
        # a column's bits are those of a call on that column alone
        for j in range(m):
            alone = bootstrap_partials(x[:, j : j + 1].contiguous(), seed, start,
                                       n_boot=n_boot)
            require(all(bool(torch.equal(a[:, 0], b[:, j]))
                        for a, b in zip(alone, got)),
                    f"bootstrap_partials n={n} m={m}: column {j} differs alone")
    shape = (f"n={n} m={m} n_boot={n_boot} seed={seed} start="
             + "/".join(str(s) for s in starts))
    require(max(r for _, r in errs) <= 1.0, f"bootstrap_partials {shape}: {errs}")
    x, start = xs[0], starts[0]
    groups = -(-m // 8)
    # n * n_boot draws, one NaN test per (example, metric), an FMA and an
    # add (2 instructions, 3 FLOPs) per (draw, metric)
    b_ms, b_by = draw_bound(torch, n * n_boot, n * m, 2 * n * m * n_boot,
                            3 * n * m * n_boot, 4 * (n * m + 2 * n_boot * m))
    entry = {
        "name": "bootstrap_partials",
        "route": "cuda",
        "source": "src/repro_torch/csrc/bootstrap.cu",
        "replaces": "src/repro/kernels/bootstrap/bootstrap.py:199",
        "shape": shape,
        "max_abs_err": max(e for e, _ in errs),
        "ms": time_ms(torch, lambda: bootstrap_partials(x, seed, start, n_boot=n_boot)),
        # one device kernel a call per group of 8 columns, gated
        "device_ms": device_profile(
            torch, lambda: bootstrap_partials(x, seed, start, n_boot=n_boot), groups),
        "device_kernels": groups,
        "plain_ms": time_ms(
            torch, lambda: bootstrap_partials_ref(x, seed, start, n_boot=n_boot),
            iters=plain_iters, warmup=1),
        "library_ms": None,
        "bound_ms": b_ms,
        "bound_by": b_by,
    }
    log(f"bootstrap_partials {shape}: err {entry['max_abs_err']:.3g}, every column "
        f"bit-equal alone, {groups} launch(es) and device kernel(s) a call; "
        f"{entry['ms']:.4g} ms (device {entry['device_ms']:.4g}), "
        f"plain {entry['plain_ms']:.4g} ms, bound {b_ms:.4g} ms ({b_by})")
    return entry


def ssd_work(slen: int, chunk: int, h: int = SSM_HEADS,
             n: int = SSM_STATE) -> tuple[int, int]:
    """FLOPs and bytes of one full-width SSD scan of one sequence in the
    chunked form.  FLOPs per
    head and chunk of ``q`` rows: the causal half of the intra-chunk
    products (C B^T over N, then S x over P), q(q+1)/2 (N + P)
    multiply-adds, and the chunk-state and off-diagonal products, 2 q P N;
    a ragged last chunk counts its own rows only.  Bytes: x, dt, B and C
    per group, y, the final state and ``a``, each once."""
    p, g = SSM_HEAD_DIM, SSM_GROUPS
    q = min(chunk, slen)
    macs = 0
    for c0 in range(0, slen, q):
        qv = min(q, slen - c0)
        macs += qv * (qv + 1) // 2 * (n + p) + 2 * qv * p * n
    flops = 2 * macs * h
    nbytes = slen * (h * p * 2 * 2 + h * 4 + 2 * g * n * 2) + h * p * n * 4 + h * 4
    return flops, nbytes


def ssd_cases(torch, fs) -> list[dict]:
    """Kernel 8 at full-width mamba2-2.7b geometry (80 heads of 64 on one
    group of 128, chunk 256, batch 1) at 12 tokens (one partial chunk),
    phase 4's prompt length (two chunks, the second ragged) and 2,048 (8
    chunks), and at zamba2-7b's (112 heads of 64 on one group of state 64)
    at 12 tokens and phase 12's prompt length; x, B and C are column views
    of one fused xBC row, as the model slices them."""
    from repro_torch.kernels.ssd import ssd
    from repro_torch.models.ssm import ssd_chunked

    p, g = SSM_HEAD_DIM, SSM_GROUPS
    out = []
    mamba, zamba = (SSM_HEADS, SSM_STATE), (ZAMBA_SSM_HEADS, ZAMBA_SSM_STATE)
    for slen, (h, n) in ((12, mamba), (fs.prompt_len, mamba), (2048, mamba),
                         (12, zamba), (fs.prompt_len, zamba)):
        gen = torch.Generator(device="cuda").manual_seed(
            10 + slen + (0 if n == SSM_STATE else 1000))
        xbc = torch.randn((1, slen, h * p + 2 * g * n), generator=gen,
                          device="cuda").to(torch.bfloat16)
        x = xbc[..., : h * p].unflatten(-1, (h, p))
        bm = xbc[..., h * p : h * p + g * n].unflatten(-1, (g, n))
        cm = xbc[..., h * p + g * n :].unflatten(-1, (g, n))
        dt = torch.nn.functional.softplus(
            torch.randn((1, slen, h), generator=gen, device="cuda"))
        # a in [-e, -1]: the served model's A_log = 1 gives -e
        a = -torch.exp(torch.rand((h,), generator=gen, device="cuda"))
        args = (x, dt, a, bm, cm)
        y, state = ssd(*args, chunk=SSM_CHUNK)
        ry, rstate = ssd_chunked(*args, SSM_CHUNK)
        torch.cuda.synchronize()
        shape = (f"B=1 L={slen} H={h} P={p} N={n} G={g} chunk={SSM_CHUNK}, "
                 f"x/B/C strided views")
        # y: f32 on both sides until the final bf16 rounding (one bf16 ulp,
        # 2^-7 of the value) plus 1e-3 of the row's largest output where
        # terms cancel.  The state: f32 on both sides, summed in other
        # orders (the running sum of dt*a, the chunk's products): 2^-10 of
        # the value plus 1e-4 of the row's largest.  A dropped 32-row tile
        # or chunk moves either by whole units of the allowance's scale.
        err_y, ratio_y = rowwise(torch, y, ry, 2**-7, 1e-3)
        err_s, ratio_s = rowwise(torch, state, rstate, 2**-10, 1e-4)
        require(ratio_y <= 1.0, f"ssd {shape}: y error/allowance {ratio_y:.3g}")
        require(ratio_s <= 1.0, f"ssd {shape}: state error/allowance {ratio_s:.3g}")
        flops, nbytes = ssd_work(slen, SSM_CHUNK, h, n)
        b_ms, b_by = bound(flops, PEAK_BF16, nbytes)
        entry = {
            "name": "ssd",
            "route": "cuda",
            "source": "src/repro_torch/csrc/ssd.cu",
            "replaces": "src/repro/kernels/ssd/ssd.py:90",
            "shape": shape,
            "max_abs_err": max(err_y, err_s),
            "ms": time_ms(torch, lambda: ssd(*args, chunk=SSM_CHUNK)),
            "plain_ms": time_ms(torch, lambda: ssd_chunked(*args, SSM_CHUNK),
                                iters=5),
            "library_ms": None,
            "bound_ms": b_ms,
            "bound_by": b_by,
        }
        # three device kernels a call: chunk states, recurrence, outputs
        entry["device_ms"] = device_profile(
            torch, lambda: ssd(*args, chunk=SSM_CHUNK), 3)
        out.append(entry)
        n_diff = int((state != rstate).sum())
        log(f"ssd {shape}: y err {err_y:.3g} (ratio {ratio_y:.3g}), state err "
            f"{err_s:.3g} (ratio {ratio_s:.3g}; max |state| "
            f"{float(rstate.abs().max()):.4g}, {n_diff} of {state.numel()} "
            f"elements not bit-equal); {entry['ms']:.4g} ms (device "
            f"{entry['device_ms']:.4g} ms, three kernels), plain "
            f"{entry['plain_ms']:.4g} ms, bound {b_ms:.4g} ms ({b_by}; "
            f"{flops} FLOPs, {nbytes} bytes)")
    kernel_limits("repro_ssd_kernel_info",
                  {0: "ssd chunk states and C B^T", 1: "ssd recurrence",
                   2: "ssd outputs", 3: "ssd N=64 chunk states and C B^T",
                   4: "ssd N=64 recurrence", 5: "ssd N=64 outputs"})
    return out


def rel_check(torch, out, ref, rtol: float, atol: float) -> tuple[float, float]:
    """|out - ref| <= rtol*|ref| + atol elementwise (NaN nowhere).  Returns
    (max abs error over the values that are not the -1e30 sentinel's, worst
    ratio of error to allowance); a ratio above 1 fails."""
    o, r = out.double(), ref.double()
    require(not bool(torch.isnan(o).any()), "kernel output holds NaN")
    err = (o - r).abs()
    ratio = float((err / (rtol * r.abs() + atol)).max())
    plain = r.abs() < 1e29
    return float(err[plain].max()) if bool(plain.any()) else 0.0, ratio


def bertscore_cases(torch) -> list[dict]:
    """Kernel 7 at the semantic metric's widths (64 tokens a side, hash
    embeddings of 256) at B = 16 (phase 5's chunk), 1,024 (the reference's
    default chunk) and 16,384, and at ``max_len = 1,024`` (B = 16).  Random
    embeddings stand in for the hash vectors; each example keeps a random
    prefix of its tokens (at 1,024, whole 64-row tiles past it empty), and
    examples 0-3 are the edges: an empty candidate, an empty reference,
    both empty, and one pair at cosine -0.995 (F1 ~ 2e9); at 1,024, example
    4 also keeps only candidate tokens 0-63 and 960-999."""
    from repro_torch.kernels.bertscore import bertscore, bertscore_pr, bertscore_ref
    from repro_torch.kernels.bertscore.ref import f1_from_pr

    d = BERT_DIM
    out = []
    for b, lc in ((CHUNK, BERT_LEN), (1024, BERT_LEN), (16384, BERT_LEN),
                  (CHUNK, BERT_LONG)):
        lr = lc
        # the 64-token rows keep the seeds they had
        g = torch.Generator(device="cuda").manual_seed(20 + b + lc - BERT_LEN)
        cand = torch.randn((b, lc, d), generator=g, device="cuda")
        ref = torch.randn((b, lr, d), generator=g, device="cuda")
        nc = torch.randint(1, lc + 1, (b,), generator=g, device="cuda")
        nr = torch.randint(1, lr + 1, (b,), generator=g, device="cuda")
        nc[0], nr[1], nc[2], nr[2], nc[3], nr[3] = 0, 0, 0, 0, 1, 1
        cand[3, 0].zero_()
        ref[3, 0].zero_()
        cand[3, 0, 0] = 1.0
        ref[3, 0, 0], ref[3, 0, 1] = -0.995, (1 - 0.995**2) ** 0.5
        cm = (torch.arange(lc, device="cuda")[None, :] < nc[:, None]).float()
        rm = (torch.arange(lr, device="cuda")[None, :] < nr[:, None]).float()
        if lc > 512 and b > 4:
            cm[4].zero_()
            cm[4, :64] = 1.0
            cm[4, 960:1000] = 1.0
        args = (cand, ref, cm, rm)
        got = bertscore(*args)
        want = bertscore_ref(*args)
        torch.cuda.synchronize()
        # P and R: rsqrt-normalised f32 FMA in one fixed order against a
        # normalised einsum, 1e-5 of the value plus 1e-6.  A masked pair that
        # leaks in, or a dropped 64-token tile, moves P or R by ~1e-2.  F1 is
        # the epilogue on P and R, ill-conditioned where p + r nears 0, so it
        # is held to the epilogue on the kernel's own P and R, bit for bit.
        checks = [rel_check(torch, a, w, 1e-5, 1e-6)
                  for a, w in zip(got[:2], want[:2])]
        require(bool(torch.equal(got[2], f1_from_pr(got[0], got[1]))),
                "bertscore F1 is not the epilogue of the kernel's P and R")
        holes = ", example 4 holed (tokens 0-63, 960-999)" if lc > 512 else ""
        shape = (f"B={b} Lc={lc} Lr={lr} D={d}, random prefix masks, 4 edge rows"
                 f"{holes} (max_abs_err leaves out the -1e30 sentinel rows)")
        ratio = max(r for _, r in checks)
        require(ratio <= 1.0, f"bertscore_pr {shape}: error/allowance {ratio:.3g}")
        require(1.9e9 < float(got[2][3]) < 2.1e9, f"bertscore_pr: F1 {got[2][3]}")
        pr = bertscore_pr(*args)
        alone = bertscore_pr(*(t[5:6].contiguous() for t in args))
        torch.cuda.synchronize()
        require(all(bool(torch.equal(a, full[5:6])) for a, full in zip(alone, pr)),
                f"bertscore_pr {shape}: example 5 alone is not bit-equal")
        nbytes = 4 * b * (lc * d + lr * d + lc + lr) + 2 * 4 * b
        b_ms, b_by = bound(2 * lc * lr * d * b, PEAK_F32, nbytes)
        def unit_rows(t):
            return t * torch.rsqrt(torch.clamp((t * t).sum(-1, keepdim=True),
                                               min=1e-18))

        cn, rn_t = unit_rows(cand), unit_rows(ref).transpose(1, 2)
        entry = {
            "name": "bertscore_pr",
            "route": "cuda",
            "source": "src/repro_torch/csrc/bertscore.cu",
            "replaces": "src/repro/kernels/bertscore/bertscore.py:79",
            "shape": shape,
            "max_abs_err": max(e for e, _ in checks),
            "ms": time_ms(torch, lambda: bertscore_pr(*args)),
            "device_ms": device_profile(torch, lambda: bertscore_pr(*args), 1),
            "plain_ms": time_ms(torch, lambda: bertscore_ref(*args), iters=5),
            # no one PyTorch call computes P and R; torch.bmm of the
            # normalised inputs is the product alone, without the masks and
            # maxima: a lower bound on any library version, kept apart
            "library_ms": None,
            "bmm_only_ms": time_ms(torch, lambda: torch.bmm(cn, rn_t)),
            "bound_ms": b_ms,
            "bound_by": b_by,
        }
        out.append(entry)
        log(f"bertscore_pr {shape}: err {entry['max_abs_err']:.3g} (ratio "
            f"{ratio:.3g}), example 5 bit-equal alone; {entry['ms']:.4g} ms "
            f"(device {entry['device_ms']:.4g}), "
            f"plain {entry['plain_ms']:.4g} ms, bmm of the normalised inputs "
            f"alone (TF32 off; a lower bound, not the same function) "
            f"{entry['bmm_only_ms']:.4g} ms, bound {b_ms:.4g} ms ({b_by})")
        del args, got, want, cand, ref, cn, rn_t
        free_cuda(torch)
    kernel_limits("repro_bertscore_kernel_info",
                  {0: "bertscore_pr, 16-byte staging",
                   1: "bertscore_pr, 4-byte staging (D % 4 != 0)"})
    return out


def bootstrap_means_cases(torch) -> list[dict]:
    """Kernel 5 at B = 1,000, the default the Pallas kernel refuses, over
    n = 64, 100,000 and 1,000,000 uniform scores (phase 5's size last)."""
    from repro_torch.kernels.bootstrap import bootstrap_means, bootstrap_means_ref

    out = []
    for n in (64, 100_000, 1_000_000):
        g = torch.Generator(device="cuda").manual_seed(30 + n)
        x = torch.rand((n,), generator=g, device="cuda")
        got = bootstrap_means(x, 0, n_boot=N_BOOT)
        ref = bootstrap_means_ref(x, N_BOOT, 0)
        torch.cuda.synchronize()
        # identical weights, f32 sums in two fixed orders: 2e-6 of the value
        # (the H100 showed 3.5e-7).  A dropped tile of W_T weight takes out
        # its sum w x and sum w, moving a mean by W_T (mean - m_T) / sum w:
        # ~1e-5 (2e-5 of the value) at n = 10^6 for a 1,024-row or the ragged
        # 576-row last tile, ~1e-4 at n = 100,000
        err, ratio = rowwise(torch, got, ref, 2e-6, 1e-7)
        shape = f"n={n} n_boot={N_BOOT} seed=0"
        require(ratio <= 1.0, f"bootstrap_means {shape}: error/allowance {ratio:.3g}")
        # n * N_BOOT draws, an FMA and an add (2 instructions, 3 FLOPs) a draw
        b_ms, b_by = draw_bound(torch, n * N_BOOT, 0, 2 * n * N_BOOT,
                                3 * n * N_BOOT, 4 * (n + N_BOOT))
        entry = {
            "name": "bootstrap_means",
            "route": "cuda",
            "source": "src/repro_torch/csrc/bootstrap.cu",
            "replaces": "src/repro/kernels/bootstrap/bootstrap.py:85",
            "shape": shape,
            "max_abs_err": err,
            "ms": time_ms(torch, lambda: bootstrap_means(x, 0, n_boot=N_BOOT)),
            # two device kernels a call: the tiles, then their sum
            "device_ms": device_profile(
                torch, lambda: bootstrap_means(x, 0, n_boot=N_BOOT), 2),
            "plain_ms": time_ms(torch, lambda: bootstrap_means_ref(x, N_BOOT, 0),
                                iters=1 if n > 100_000 else 3, warmup=1),
            "library_ms": None,
            "bound_ms": b_ms,
            "bound_by": b_by,
        }
        out.append(entry)
        log(f"bootstrap_means {shape}: err {err:.3g} (ratio {ratio:.3g}) "
            f"{entry['ms']:.4g} ms (device {entry['device_ms']:.4g}), plain "
            f"{entry['plain_ms']:.4g} ms, bound {b_ms:.4g} ms ({b_by}), "
            f"{b_ms / entry['device_ms']:.0%} of it")
    kernel_limits("repro_bootstrap_kernel_info",
                  {m: f"bootstrap_partials, {m} column(s)" for m in range(1, 9)})
    return out


def kernel_phase(torch, fs) -> list[dict]:
    from repro_torch.core import StatisticsConfig, StreamingConfig

    seed = StatisticsConfig().seed
    entries = [
        *flash_cases(torch, fs),
        *decode_cases(torch),
        *paged_cases(torch, fs),
        # the main path's calls: one per chunk, at the chunk's first position
        bootstrap_case(torch, CHUNK, 2, N_BOOT,
                       tuple(range(0, N_ROWS, CHUNK)), seed, plain_iters=20),
        # a full-size statistics chunk whose position counter wraps past 2^32
        bootstrap_case(torch, 100_000, 4, 2_000, (2**32 - 50_000,), 7,
                       plain_iters=3),
        # a chunk of a task with 13 metric configs: two column groups
        bootstrap_case(torch, CHUNK, 13, N_BOOT, (0, CHUNK), seed, plain_iters=20),
        # the default streaming chunk (StreamingConfig.max_memory_rows) with
        # phase 5's seven metrics
        bootstrap_case(torch, StreamingConfig().max_memory_rows, len(METRICS),
                       N_BOOT, (0,), seed, plain_iters=5),
        *ssd_cases(torch, fs),
        *bertscore_cases(torch),
        *bootstrap_means_cases(torch),
    ]
    log(f"phase 1 device profiles: {PROFILE_TRACES['profiles']} taken, "
        f"{PROFILE_TRACES['retakes']} trace(s) taken again for a missing record, "
        f"{PROFILE_TRACES['estimated']} read from per-kernel means, "
        f"{PROFILE_TRACES['events']} from CUDA events")
    return entries


# -- phase 2: the contiguous main path ---------------------------------------------

KERNEL_NAMES = ("flash_attention", "decode_attention", "paged_decode_attention",
                "quant_paged_decode_attention", "bootstrap_means",
                "bootstrap_partials", "bertscore_pr", "ssd")


def counters():
    from repro_torch.kernels.bertscore import bertscore_pr
    from repro_torch.kernels.bootstrap import bootstrap_means, bootstrap_partials
    from repro_torch.kernels.decode_attention import (
        decode_attention,
        paged_decode_attention,
        quant_paged_decode_attention,
    )
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd import ssd

    return dict(zip(KERNEL_NAMES, (
        flash_attention, decode_attention, paged_decode_attention,
        quant_paged_decode_attention, bootstrap_means, bootstrap_partials,
        bertscore_pr, ssd,
    )))


def make_task(template: str | None = None, model_name: str = "qwen3-4b",
              **inference):
    from repro_torch.core import (
        DataConfig,
        EngineModelConfig,
        EvalTask,
        InferenceConfig,
        MetricConfig,
        StatisticsConfig,
        StreamingConfig,
    )

    model = EngineModelConfig(provider="torch_local", model_name=model_name,
                              reduced=False, seed=0, max_tokens=MAX_TOKENS)
    data = DataConfig() if template is None else DataConfig(prompt_template=template)
    return EvalTask(
        task_id=f"qa-{model_name}",
        model=model,
        inference=InferenceConfig(**inference),
        data=data,
        metrics=(MetricConfig("exact_match"), MetricConfig("token_f1")),
        statistics=StatisticsConfig(bootstrap_iterations=N_BOOT,
                                    ci_method="percentile", backend="device"),
        streaming=StreamingConfig(enabled=True, max_memory_rows=CHUNK),
    )


def unit_range(name: str, mv) -> None:
    """Phases 2-4: a lexical metric and its interval within [0, 1]."""
    require(0.0 <= mv.ci[0] <= mv.value <= mv.ci[1] <= 1.0,
            f"{name}: bad interval {mv}")


def serving_clean(session, label: str) -> str:
    """Every service of ``session`` has restarted no replica and failed no
    request.  A run without an injected fault must show this: at the
    default ``max_replica_restarts=2`` a crashed engine is reset and its
    rows are served again, with the same texts and no other sign.  Returns
    the counts to log."""
    snaps = session.serving_stats()
    restarts = sum(s["restarts"] for s in snaps)
    errors = sum(s["errors"] for s in snaps)
    require(restarts == 0 and errors == 0,
            f"{label}: {restarts} replica restarts, {errors} failed requests "
            f"({[(s['engine'], s['restarts'], s['errors']) for s in snaps]})")
    return f"services: restarts {restarts}, errors {errors}"


def timed_run_task(torch, session, task, kernels: tuple[str, ...], label: str,
                   check_metric=unit_range, n_rows: int = N_ROWS):
    """``run_task`` over the phase's ``n_rows`` QA rows with every launch
    count set to 0 just before and read just after; each of ``kernels``
    must have launched, and every metric pass ``check_metric(name, value)``.
    Returns (launches, serving stats, wall seconds, result)."""
    from repro_torch.data import iter_qa_examples

    engine = session.engine_for(task.model, task.inference)
    # an engine that served before (phase 5 reuses phase 2's) counts on
    # from there: the serving numbers below are this run's differences
    before = engine.serving_stats()
    for fn in counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    result = session.run_task(iter_qa_examples(n_rows, seed=0), task)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters().items()}
    log(f"{label} launches: {launches}")
    for name in kernels:
        require(launches[name] > 0, f"{name} was not launched on {label}")

    st = engine.serving_stats()
    run = {k: st[k] - before.get(k, 0) for k in
           ("admissions", "steps", "tokens_generated", "prefill_s", "decode_s")}
    prefill_ms = run["prefill_s"] * 1e3 / run["admissions"]
    step_ms = run["decode_s"] * 1e3 / run["steps"]
    generated = run["tokens_generated"] + run["admissions"]  # + first tokens
    log(f"{label}: run_task wall {wall:.3f} s for {n_rows} examples; "
        f"{run['admissions']} prefills, {prefill_ms:.2f} ms each; "
        f"{run['steps']} decode steps, {step_ms:.2f} ms each (batch {N_SLOTS}); "
        f"{run['tokens_generated']} decoded tokens, "
        f"{run['tokens_generated'] / run['decode_s']:.1f} tokens/s in decode, "
        f"{generated / wall:.1f} generated tokens/s end to end; "
        f"{serving_clean(session, label)}")
    if task.streaming.enabled:
        require(result.logs["streaming"]["n_examples"] == n_rows, "examples lost")
    else:
        require(len(result.responses) == n_rows
                and all(v.shape == (n_rows,) for v in result.scores.values()),
                "in memory: responses or per-example scores lost")
    for name, mv in result.metrics.items():
        log(f"{label} metric {name}: {mv} ({mv.ci_method})")
        require(mv.n == n_rows, f"{name}: scored {mv.n} of {n_rows}")
        check_metric(name, mv)
    return launches, st, wall, result


def metric_range(name: str, mv) -> None:
    """Phase 5: every interval brackets its value; lexical metrics lie in
    [0, 1] and cosine similarity in [-1, 1]; BERTScore's F1 only has to be
    finite, since the reference's epilogue can leave [0, 1].  The value is
    an f64 mean and the interval's ends are replicate means of f32 partial
    sums, so where every score is equal (BLEU gives every 32-token answer
    without a matching word the same ~4e-4) the ends may round to either
    side of it by the f32 rounding of the scores and of a 16-row chunk's
    sums, at most ~1e-6 of the value: the bracket allows 1e-5 of it."""
    lo, hi = mv.ci
    slack = 1e-5 * abs(mv.value)
    require(math.isfinite(lo) and math.isfinite(hi)
            and lo - slack <= mv.value <= hi + slack,
            f"{name}: bad interval {mv}: ({lo!r}, {hi!r}) around {mv.value!r}")
    if name == "embedding_similarity":
        require(-1.0 <= lo and hi <= 1.0, f"{name}: outside [-1, 1]: {mv}")
    elif name != "bertscore":
        require(0.0 <= lo and hi <= 1.0, f"{name}: outside [0, 1]: {mv}")


def metrics_phase(torch, session, base_task) -> dict[str, int]:
    """Phase 5: ``run_task`` over phase 2's QA rows with the seven metrics and
    the default ``ci_method`` (bca) in phase 2's session, BERTScore through
    kernel 7 once per 16-row chunk; the same task in memory (the default
    ``StreamingConfig()``) and streaming under ``analytical``; then the
    statistics API ``bootstrap_ci`` on the card over a million scores at B
    = 1,000 through kernel 5.  Returns the launches of the streaming run
    and of ``bootstrap_ci``."""
    import dataclasses

    import numpy as np

    from repro_torch.core import MetricConfig, StatisticsConfig, StreamingConfig
    from repro_torch.kernels.bootstrap import bootstrap_means, bootstrap_means_ref
    from repro_torch.metrics import BINARY_METRICS
    from repro_torch.stats import bootstrap_ci, compute_ci, streaming_ci, t_interval

    task = dataclasses.replace(
        base_task, task_id="qa-qwen3-4b-metrics",
        metrics=tuple(MetricConfig(m, type=t) for m, t in METRICS),
        statistics=StatisticsConfig(bootstrap_iterations=N_BOOT, backend="device"),
    )
    require(task.statistics.ci_method == "bca", "the default ci_method is not bca")
    launches, _, wall, result = timed_run_task(
        torch, session, task,
        ("flash_attention", "decode_attention", "bootstrap_partials",
         "bertscore_pr"),
        "metrics path", check_metric=metric_range)
    require(launches["bertscore_pr"] == N_ROWS // CHUNK,
            f"bertscore_pr launched {launches['bertscore_pr']} times, not "
            f"{N_ROWS // CHUNK} (one per chunk)")
    stages = ", ".join(f"{k} {v:.4f} s" for k, v in result.timing.items())
    log(f"metrics path per-stage seconds (run_task wall {wall:.3f} s): {stages}")
    for name, _ in METRICS:
        iv = streaming_ci(result.stream_stats.accs[name], None,
                          method="analytical", binary=name in BINARY_METRICS)
        log(f"metrics path {name}: analytical {iv.method} interval "
            f"({iv.lo:.6g}, {iv.hi:.6g}) beside the bootstrap's "
            f"({result.metrics[name].ci[0]:.6g}, {result.metrics[name].ci[1]:.6g})")

    # the reference's default path: the same task with the default
    # StreamingConfig() runs in memory, BCa over exact multinomial resamples
    # drawn on the card, and keeps the per-example scores
    inmem = dataclasses.replace(task, task_id="qa-qwen3-4b-inmemory",
                                streaming=StreamingConfig())
    mem_launches, _, mem_wall, mem = timed_run_task(
        torch, session, inmem, ("flash_attention", "decode_attention", "bertscore_pr"),
        "in-memory path", check_metric=metric_range)
    require(all(mv.ci_method == "bca" for mv in mem.metrics.values()),
            f"in memory: methods {[mv.ci_method for mv in mem.metrics.values()]}")
    require(mem_launches["bootstrap_partials"] == 0,
            "in memory: the streaming partials kernel was launched")
    require(mem_launches["bertscore_pr"] == 1,
            f"in memory: bertscore_pr launched {mem_launches['bertscore_pr']} "
            f"times, not once over the {N_ROWS} rows")
    # the threefry draws and BCa on the card against the same on the CPU:
    # 0/1 scores have exact f32 replicate sums, so the two agree bit for bit
    st = inmem.statistics
    em = mem.metrics["exact_match"]
    cpu = compute_ci(mem.scores["exact_match"], method="bca",
                     confidence=st.confidence_level, n_boot=st.bootstrap_iterations,
                     seed=st.seed, device="cpu")
    require((em.value, *em.ci) == (cpu.value, cpu.lo, cpu.hi),
            f"in memory: exact_match {em.value!r} {em.ci!r} on the card, "
            f"{cpu.value!r} ({cpu.lo!r}, {cpu.hi!r}) on the CPU")
    log(f"in-memory exact_match BCa on the card equals the CPU's bit for bit: "
        f"{em.value!r} ({em.ci[0]!r}, {em.ci[1]!r})")
    stages = ", ".join(f"{k} {v:.4f} s" for k, v in mem.timing.items())
    log(f"in-memory path per-stage seconds (run_task wall {mem_wall:.3f} s): "
        f"{stages}; the stats stage (BCa for {len(METRICS)} metrics at B={N_BOOT}) "
        f"{mem.timing['stats_s']:.4f} s")

    # analytical intervals keep no replicate state: no partials launch
    analytical = dataclasses.replace(
        task, task_id="qa-qwen3-4b-analytical",
        statistics=StatisticsConfig(ci_method="analytical"))
    an_launches, *_, an = timed_run_task(
        torch, session, analytical, ("flash_attention", "decode_attention"),
        "analytical streaming path", check_metric=metric_range)
    require(an_launches["bootstrap_partials"] == 0 and an.stream_stats.engine is None,
            f"analytical: {an_launches['bootstrap_partials']} bootstrap_partials "
            f"launches, engine {an.stream_stats.engine}")
    log("analytical streaming path: no bootstrap engine, 0 bootstrap_partials "
        "launches")

    scores = np.random.default_rng(0).random(N_SCORES).astype(np.float32)
    x = torch.from_numpy(scores).to(session.device)
    for fn in counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    mean, lo, hi = (float(v) for v in bootstrap_ci(x, 0, n_boot=N_BOOT))
    ci_s = time.perf_counter() - t0
    launches["bootstrap_means"] = bootstrap_means.launches
    require(launches["bootstrap_means"] >= 1, "bootstrap_means was not launched")
    require(lo <= mean <= hi, f"bootstrap_ci: mean {mean} outside ({lo}, {hi})")
    # the interval against the quantiles of the plain version's means on the
    # card: each end is a linear blend of two order statistics, which move
    # no more than the means do, so phase 1's 2e-6 of the value holds
    ref = bootstrap_means_ref(x, N_BOOT, 0)
    alpha = (1.0 - 0.95) / 2.0
    ends = torch.tensor([lo, hi], dtype=torch.float32)
    ref_ends = torch.stack([torch.quantile(ref, alpha),
                            torch.quantile(ref, 1.0 - alpha)]).cpu()
    err, ratio = rowwise(torch, ends, ref_ends, 2e-6, 1e-7)
    require(ratio <= 1.0, f"bootstrap_ci ends {(lo, hi)} against the plain "
            f"version's {ref_ends.tolist()}: error/allowance {ratio:.3g}")
    t_iv = t_interval(scores)
    width, t_width = hi - lo, t_iv.hi - t_iv.lo
    log(f"bootstrap_ci over {N_SCORES} scores, B={N_BOOT}: mean {mean:.7g}, "
        f"({lo:.7g}, {hi:.7g}) in {ci_s:.4f} s host clock (first call); "
        f"{launches['bootstrap_means']} bootstrap_means launch; the ends "
        f"within {err:.3g} of the plain version's (ratio {ratio:.3g}); width "
        f"{width:.6g} against the t-interval's {t_width:.6g} "
        f"({width / t_width:.4f})")
    require(abs(width / t_width - 1.0) <= 0.25,
            f"bootstrap_ci width {width:.6g} is not within 25% of the "
            f"t-interval's {t_width:.6g}")
    return launches


def engine_gates(torch, engine, task, label: str) -> None:
    """On a contiguous engine after its ``run_task``: a prompt's greedy
    tokens do not depend on the batch around it; one prefill and one
    decode step on slot 0 give finite logits; and where the time of a
    16-slot decode step and of a prefill (a main-path prompt, and phase
    3's length in full) goes, with the share of the expert products on a
    MoE model."""
    from repro_torch.core import InferenceRequest
    from repro_torch.data import iter_qa_examples, render

    rows = list(iter_qa_examples(N_SLOTS, seed=0))
    reqs = [InferenceRequest(render(task.data.prompt_template, r), MAX_TOKENS)
            for r in rows]
    full = engine.infer_batch(reqs)
    alone = engine.infer_batch(reqs[:1])
    require(full[0].text == alone[0].text
            and full[0].output_tokens == alone[0].output_tokens,
            f"{label}: batch-dependent tokens: {full[0].text!r} vs {alone[0].text!r}")
    log(f"{label} batch invariance: prompt 0 gives {alone[0].output_tokens} "
        f"identical tokens alone and among {N_SLOTS} slots")

    b = engine.batcher
    toks = torch.tensor([[2, 5, 7, 11]], device="cuda")
    logits = b.model.prefill(b.params, toks, b.cache, 0)
    nxt = logits.argmax(-1).repeat(N_SLOTS)[:, None]
    pos = torch.full((N_SLOTS,), 4, device="cuda")
    step = b.model.decode_step(b.params, nxt, b.cache, pos)
    require(bool(torch.isfinite(logits).all() and torch.isfinite(step).all()),
            f"{label}: logits hold NaN or inf")
    busy = step_breakdown(
        torch, f"{label} decode step (batch {N_SLOTS}, all slots at position 4)",
        lambda: b.model.decode_step(b.params, nxt, b.cache, pos),
        kernel=DEVICE_KERNEL["decode_attention"])
    expert_share(torch, b, N_SLOTS, 1, busy)
    for n_tok in (PROMPT_LEN, 478):
        toks = torch.arange(2, 2 + n_tok, device="cuda")[None, :]
        busy = step_breakdown(torch, f"{label} prefill ({n_tok} tokens into slot 0)",
                              lambda: b.model.prefill(b.params, toks, b.cache, 0),
                              kernel="flash")
        expert_share(torch, b, 1, n_tok, busy)


def expert_share(torch, batcher, b: int, s: int, busy_ms: float | None) -> None:
    """The expert products' device time in a call of ``b`` rows of ``s``
    tokens: one MoE layer's products at the call's dispatch shape (E, b *
    min(capacity, s), d), timed apart with CUDA events (each call reads the
    layer's 1.2 GB of experts, past the L2), times the MoE layers, against
    the call's device-busy time.  A dense model has none."""
    from repro_torch.models import moe

    cfg, params = batcher.cfg, batcher.params
    if "moe_layers" not in params:
        return
    stack = params["moe_layers"]["moe"]
    layer = {k: stack[k][0] for k in ("wi", "wg", "wo")}
    n_layers = stack["wi"].shape[0]
    c = min(moe.expert_capacity(cfg, s), s)
    xin = torch.randn((cfg.n_experts, b * c, cfg.d_model), device="cuda").to(
        torch.bfloat16)
    ms = n_layers * time_ms(torch, lambda: moe.experts(layer, xin), iters=10)
    share = "" if busy_ms is None else f", {100 * ms / busy_ms:.1f}% of device busy"
    log(f"  expert products: {ms:.3f} ms a call ({n_layers} layers x one layer's "
        f"products at ({cfg.n_experts}, {b * c}, {cfg.d_model}) timed apart){share}")


def main_path_phase(torch) -> tuple[dict[str, int], dict[str, int], dict]:
    from repro_torch.core import EvalSession

    task = make_task()
    engine_kwargs = {"n_slots": N_SLOTS, "max_len": MAX_LEN}
    with EvalSession(device="cuda", engine_kwargs=engine_kwargs) as session:
        t0 = time.perf_counter()
        engine = session.engine_for(task.model, task.inference)
        torch.cuda.synchronize()
        log(f"engine set-up (random bf16 weights on the card): "
            f"{time.perf_counter() - t0:.3f} s, "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        launches, *_ = timed_run_task(
            torch, session, task,
            ("flash_attention", "decode_attention", "bootstrap_partials"),
            "contiguous main path")
        engine_gates(torch, engine, task, "phase 2")
        metrics = metrics_phase(torch, session, task)
        _, yard = harness_phase(torch, session, task)
        log(f"phases 2, 5 and 7 {serving_clean(session, 'phases 2, 5 and 7')}")
    return launches, metrics, yard


#: a part of the device kernel names behind each decode wrapper, for the
#: step breakdowns (kernels 2 and 3 are one template, split_decode.cuh)
DEVICE_KERNEL = {"decode_attention": "split_kernel<false",
                 "paged_decode_attention": "split_kernel<true",
                 "quant_paged_decode_attention": "quant_"}


def step_breakdown(torch, label: str, run, steps: int = 5,
                   kernel: str | None = None) -> float | None:
    """Where a step's time goes: host-clock wall per call of ``run``
    without the profiler, then device time per call by kernel from a
    ``torch.profiler`` trace of further calls (and the share of the
    kernels whose name holds ``kernel``).  Returns the device-busy ms per
    call, or None where the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    # device records only: nothing here reads the host-side ones
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
    by_name: dict[str, list[float]] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    if not by_name:
        log(f"{label}: breakdown not measured (the profiler saw no device time)")
        return None
    busy_ms = sum(sum(v) for v in by_name.values()) / 1e3 / steps
    n_events = sum(len(v) for v in by_name.values()) / steps
    log(f"{label}: {wall_ms:.2f} ms wall without the profiler; device busy "
        f"{busy_ms:.2f} ms per step ({100 * busy_ms / wall_ms:.1f}% of wall) in "
        f"{n_events:.0f} kernels and copies per step")
    if kernel is not None:
        mine = [t for name, ts in by_name.items() if kernel in name for t in ts]
        mine_ms = sum(mine) / 1e3 / steps
        log(f"  {mine_ms:.3f} ms/step ({100 * mine_ms / busy_ms:.1f}% of device "
            f"busy) in {len(mine) // steps} launches/step of the {kernel} kernel")
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:6]
    for name, times in top:
        log(f"  {sum(times) / 1e3 / steps:.3f} ms/step in {len(times) // steps} "
            f"launches/step: {name[:90]}")
    return busy_ms


# -- phase 3: the paged path ------------------------------------------------------


class FewShot:
    """Phase 3's prompt template: a header of ``k`` worked examples
    (``"Q: {question} A: {reference}"`` over ``iter_qa_examples(k,
    seed=1)``), then ``"Q: {question} A:"``.  ``k`` is the least that makes
    the header at least 448 tokens; it must stay at 480 or fewer and every
    prompt within the engine's ``max_len // 2`` tokens, or the engine would
    cut the question off."""

    def __init__(self):
        from repro_torch.configs import get_config
        from repro_torch.data import HashTokenizer, iter_qa_examples, render

        tok = HashTokenizer(get_config("qwen3-4b").vocab_size)
        for k in range(1, 100):
            header = " ".join(f"Q: {r['question']} A: {r['reference']}"
                              for r in iter_qa_examples(k, seed=1))
            if len(tok.encode(header)) >= HEADER_TOKENS[0]:
                break
        self.k, self.header_tokens = k, len(tok.encode(header))
        require(self.header_tokens <= HEADER_TOKENS[1],
                f"header of {self.header_tokens} tokens")
        self.template = header + " Q: {question} A:"
        prompts = [tok.encode(render(self.template, r))
                   for r in iter_qa_examples(QA_ROWS, seed=0)]
        lens = [len(p) for p in prompts]
        require(max(lens) <= MAX_LEN // 2, f"prompts of up to {max(lens)} tokens")
        self.prompt_len = max(lens)
        common = next(i for i, (a, b) in enumerate(zip(*prompts[:2])) if a != b)
        # the paged cache shares whole pages, never the final token's page
        self.shared = min(common, min(lens) - 1) // PAGE_SIZE * PAGE_SIZE
        require((self.prompt_len - self.shared, self.prompt_len, self.shared)
                == FLASH_SHAPES[-1], "phase 3's suffix shape is not phase 1's")
        log(f"few-shot header: {self.k} examples, {self.header_tokens} tokens; "
            f"prompts {min(lens)}-{max(lens)} tokens, {self.shared} shared "
            f"({self.shared // PAGE_SIZE} pages of {PAGE_SIZE})")


class Probe:
    """Counts the suffix prefills (flash launches with ``q_offset`` > 0)
    and checks every sampled row of logits for NaN and inf without a host
    read per step; keeps the first-token logits of each prefill."""

    def __enter__(self):
        import torch

        import repro_torch.models.attention as attn
        import repro_torch.serve.steps as steps

        self._attn, self._steps = attn, steps
        self._flash, self._sample = attn.flash_attention_bshd, steps.greedy_sample
        self.suffix_prefills = 0
        self.bad = torch.zeros((), dtype=torch.int64, device="cuda")
        self.prefill_logits: list = []

        def flash(q, k, v, *, q_offset=0, causal=True, prefix_len=0):
            self.suffix_prefills += q_offset > 0
            return self._flash(q, k, v, q_offset=q_offset, causal=causal,
                               prefix_len=prefix_len)

        def sample(logits, vocab_size):
            self.bad += (~torch.isfinite(logits)).sum()
            if logits.shape[0] == 1:
                self.prefill_logits.append(logits.float().clone())
            return self._sample(logits, vocab_size)

        attn.flash_attention_bshd, steps.greedy_sample = flash, sample
        return self

    def __exit__(self, *exc):
        self._attn.flash_attention_bshd = self._flash
        self._steps.greedy_sample = self._sample


def free_cuda(torch) -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def paged_run(torch, params, fs, label, kernel, model_name="qwen3-4b",
              n_rows=N_ROWS, **inference):
    """One paged ``run_task`` of ``model_name`` over ``n_rows`` rows of the
    few-shot task with the given paging knobs; returns (launches, serving
    stats, tokens by request, texts by request)."""
    from repro_torch.core import EvalSession

    task = make_task(fs.template, model_name, kv_page_size=PAGE_SIZE, **inference)
    engine_kwargs = {"n_slots": N_SLOTS, "max_len": MAX_LEN, "params": params}
    tokens: dict[int, list[int]] = {}
    texts: dict[int, str] = {}
    with EvalSession(device="cuda", engine_kwargs=engine_kwargs) as session:
        engine = session.engine_for(task.model, task.inference)
        respond = engine._response

        def keep_tokens(c):
            tokens[c.request_id] = c.tokens
            response = respond(c)
            texts[c.request_id] = response.text
            return response

        engine._response = keep_tokens
        with Probe() as probe:
            launches, st, _, _ = timed_run_task(
                torch, session, task,
                ("flash_attention", kernel, "bootstrap_partials"), label,
                n_rows=n_rows)
        require(probe.suffix_prefills > 0,
                f"{label}: no flash launch with q_offset > 0")
        require(int(probe.bad) == 0, f"{label}: logits hold NaN or inf")
        require(st["prefix_tokens_saved"] > 0, f"{label}: no prefix shared")
        log(f"{label}: {probe.suffix_prefills} suffix-prefill flash launches; "
            f"prefix_pages_hit {st['prefix_pages_hit']}, prefix_tokens_saved "
            f"{st['prefix_tokens_saved']}, pool_pages {st['pool_pages']}, "
            f"kv_bytes_per_token {st['kv_bytes_per_token']}, preemptions "
            f"{st['preemptions']}; {torch.cuda.max_memory_allocated() / 2**30:.2f} "
            f"GiB peak allocated")

        # a decode step of the batcher with all 16 slots busy on header prompts
        from repro_torch.core import InferenceRequest
        from repro_torch.data import iter_qa_examples, render

        for r in iter_qa_examples(N_SLOTS, seed=2):
            engine.stream_submit(InferenceRequest(render(fs.template, r), MAX_TOKENS))
        engine.stream_pump()
        step_breakdown(torch, f"{label} batcher step (batch {N_SLOTS}, positions "
                       f"~{fs.prompt_len})", engine.batcher.step,
                       kernel=DEVICE_KERNEL[kernel])
        log(f"{label} {serving_clean(session, label)}")
    free_cuda(torch)
    return launches, st, tokens, texts


def infer_gates(torch, params, fs, model_name="qwen3-4b",
                pool: int | None = None) -> None:
    """Through ``infer_batch`` on 16 few-shot prompts: the paged engine
    without sharing gives the contiguous engine's texts, and so does the
    same engine with a pool of ``pool`` pages, so small that decode
    preempts (by default room for the first two prompts plus one page)."""
    from repro_torch.core import EngineModelConfig, InferenceRequest, TorchLocalEngine
    from repro_torch.data import iter_qa_examples, render

    model = EngineModelConfig(provider="torch_local", model_name=model_name,
                              reduced=False, seed=0, max_tokens=MAX_TOKENS)
    reqs = [InferenceRequest(render(fs.template, r), MAX_TOKENS)
            for r in iter_qa_examples(N_SLOTS, seed=0)]

    def serve(label, **kw):
        eng = TorchLocalEngine(model, n_slots=N_SLOTS, max_len=MAX_LEN,
                               device="cuda", params=params, **kw)
        t0 = time.perf_counter()
        with Probe() as probe:
            out = eng.infer_batch(reqs)
        torch.cuda.synchronize()
        st = eng.serving_stats()
        require(all(r.error is None for r in out), f"{label}: lost requests")
        require(int(probe.bad) == 0, f"{label}: logits hold NaN or inf")
        log(f"{label}: infer_batch of {len(reqs)} in {time.perf_counter() - t0:.3f} s, "
            f"{st['admissions']} prefills, {st['steps']} steps, preemptions "
            f"{st['preemptions']}, prefix_tokens_saved {st['prefix_tokens_saved']}")
        eng.shutdown()
        del eng
        free_cuda(torch)
        return [r.text for r in out], st, probe.prefill_logits

    contiguous, _, logits_c = serve("contiguous engine")
    paged, _, _ = serve("paged engine, no prefix sharing", kv_page_size=PAGE_SIZE,
                        prefix_cache=False)
    require(paged == contiguous, "paged (no sharing) texts differ from contiguous")
    # room for the first two prompts plus one page: both grow past it
    pool = pool or 2 * -(-fs.prompt_len // PAGE_SIZE) + 1
    tight, st, _ = serve(f"paged engine, no sharing, pool of {pool} pages",
                         kv_page_size=PAGE_SIZE, prefix_cache=False, page_pool=pool)
    require(st["preemptions"] > 0, "the small pool preempted nothing")
    require(tight == paged, "preempted texts differ from the roomy run")
    shared, _, logits_s = serve("paged engine with prefix sharing",
                                kv_page_size=PAGE_SIZE)
    n_diff = sum(a != b for a, b in zip(shared, contiguous))
    diff = max(float((a - b).abs().max()) for a, b in zip(logits_s, logits_c))
    log(f"gates passed: paged without sharing and paged under preemption give "
        f"the contiguous texts; with prefix sharing {n_diff} of {len(reqs)} texts "
        f"differ from the contiguous engine, largest first-step logit "
        f"difference {diff:.4g} (not gated)")


def paged_phase(torch, fs) -> dict[str, dict[str, int]]:
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    t0 = time.perf_counter()
    params = init_params(get_config("qwen3-4b"), 0, device="cuda")
    torch.cuda.synchronize()
    log(f"phase 3 weights on the card in {time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    f32, _, tok_f32, _ = paged_run(torch, params, fs, "paged f32 path",
                                   "paged_decode_attention", n_rows=HALF_ROWS,
                                   prefix_cache=True)
    int8, _, tok_int8, _ = paged_run(torch, params, fs, "paged int8 path",
                                     "quant_paged_decode_attention",
                                     n_rows=HALF_ROWS, kv_cache_dtype="int8")
    total = same = 0
    for rid, a in tok_f32.items():
        b = tok_int8[rid]
        total += max(len(a), len(b))
        same += sum(x == y for x, y in zip(a, b))
    log(f"int8 against f32 pool: {same} of {total} generated tokens equal "
        f"position by position ({same / total:.4f}; no floor is set)")
    infer_gates(torch, params, fs)
    return {"f32": f32, "int8": int8}


# -- phase 4: Mamba2 -------------------------------------------------------------

#: the hand-off gate: prefill(L) against prefill(L - 1) and one decode step.
#: The two paths round the last token at other points (the conv output goes
#: to bf16 before the SiLU in prefill and after it in decode, and y + D x is
#: a bf16 sum in prefill and an f32 one in decode), about one bf16 ulp (2^-8)
#: a layer, which 64 random layers compound to a few percent of the largest
#: logit.  The gate allows 15%, and the same decode step from a zeroed slot
#: must move the logits by at least 3x what the hand-off does, or the check
#: could not tell the two apart.
HANDOFF_TOL, HANDOFF_CONTROL = 0.15, 3.0


def zero_slot(cache, slot: int) -> None:
    """Every piece of a slot's state set to zeros: an SSM cache's conv
    window and state, and a hybrid cache's KV rows besides."""
    parts = (cache.conv, cache.state) if hasattr(cache, "conv") else (
        cache.ssm.conv, cache.ssm.state, cache.kv.k, cache.kv.v)
    for t in parts:
        t[:, slot].zero_()


def handoff_gate(torch, b, prompt: list[int], length: int) -> None:
    """Slot 0: the logits of ``prefill(prompt[:length])`` against those of
    ``prefill(prompt[:length - 1])`` then one ``decode_step`` (every slot
    decodes; slot 0 is read), and against the same step from a zeroed
    slot."""
    toks = torch.tensor([prompt[:length]], device="cuda")
    full = b.model.prefill(b.params, toks, b.cache, 0)
    step_toks = torch.zeros((N_SLOTS, 1), dtype=torch.int64, device="cuda")
    step_toks[0, 0] = prompt[length - 1]
    pos = torch.full((N_SLOTS,), length - 1, device="cuda")
    b.model.prefill(b.params, toks[:, : length - 1], b.cache, 0)
    step = b.model.decode_step(b.params, step_toks, b.cache, pos)[:1]
    zero_slot(b.cache, 0)
    cold = b.model.decode_step(b.params, step_toks, b.cache, pos)[:1]
    require(bool(torch.isfinite(full).all() and torch.isfinite(step).all()),
            "hand-off logits hold NaN or inf")
    scale = float(full.abs().max())
    diff = float((step - full).abs().max())
    cold_diff = float((cold - full).abs().max())
    log(f"hand-off at L={length}: max |prefill(L) - (prefill(L-1) + decode)| = "
        f"{diff:.4g} ({diff / scale:.4f} of max |logit| {scale:.4g}); from a "
        f"zeroed slot {cold_diff:.4g}; argmax {int(full.argmax())} / "
        f"{int(step.argmax())}")
    require(diff <= HANDOFF_TOL * scale,
            f"hand-off at L={length}: {diff:.4g} > {HANDOFF_TOL} x {scale:.4g}")
    require(cold_diff >= HANDOFF_CONTROL * diff,
            f"hand-off at L={length}: a zeroed slot moves the logits by "
            f"{cold_diff:.4g}, under {HANDOFF_CONTROL} x {diff:.4g}")


def mamba_phase(torch, fs) -> dict[str, int]:
    """``run_task`` on full-width mamba2-2.7b (random bf16 weights from
    seed 0) over ``HALF_ROWS`` of phase 3's few-shot prompts in chunks of
    16, 16 slots, 32 new tokens; then the gates: one prefill of each prompt
    and 64 SSD
    launches each, finite logits, the greedy tokens of a prompt alone and
    among 16 slots, the prefill-to-decode hand-off at the prompt's length
    and at 2 tokens, and a slot reused for a 1-token prompt."""
    from repro_torch.configs import get_config
    from repro_torch.core import EvalSession, InferenceRequest, TorchLocalEngine
    from repro_torch.data import iter_qa_examples, render
    from repro_torch.models import init_params

    cfg = get_config("mamba2-2.7b")
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    log(f"phase 4 weights on the card in {time.perf_counter() - t0:.3f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    torch.cuda.reset_peak_memory_stats()
    task = make_task(fs.template, model_name=cfg.name)
    engine_kwargs = {"n_slots": N_SLOTS, "max_len": MAX_LEN, "params": params}
    with EvalSession(device="cuda", engine_kwargs=engine_kwargs) as session:
        engine = session.engine_for(task.model, task.inference)
        with Probe() as probe:
            launches, st, *_ = timed_run_task(
                torch, session, task, ("ssd", "bootstrap_partials"), "mamba2 path",
                n_rows=HALF_ROWS)
        require(st["admissions"] == HALF_ROWS, f"{st['admissions']} prefills")
        require(launches["ssd"] == cfg.n_layers * HALF_ROWS,
                f"ssd launched {launches['ssd']} times, not "
                f"{cfg.n_layers} x {HALF_ROWS}")
        require(int(probe.bad) == 0, "mamba2 path: logits hold NaN or inf")
        b = engine.batcher
        slot_bytes = (b.cache.conv[:, 0].numel() + b.cache.state[:, 0].numel()) * 4
        log(f"mamba2 path: ssd {launches['ssd']} launches = {cfg.n_layers} layers "
            f"x {st['admissions']} prefills; state bytes per slot {slot_bytes} "
            f"({b.cache.state[:, 0].numel() * 4} SSD state + "
            f"{b.cache.conv[:, 0].numel() * 4} conv window), "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB peak allocated")

        rows = list(iter_qa_examples(N_SLOTS, seed=0))
        reqs = [InferenceRequest(render(fs.template, r), MAX_TOKENS) for r in rows]
        full = engine.infer_batch(reqs)
        alone = engine.infer_batch(reqs[:1])
        require(full[0].text == alone[0].text
                and full[0].output_tokens == alone[0].output_tokens,
                f"batch-dependent tokens: {full[0].text!r} vs {alone[0].text!r}")
        log(f"batch invariance: prompt 0 gives {alone[0].output_tokens} identical "
            f"tokens alone and among {N_SLOTS} slots")

        # slot 0 last served a few-shot prompt; an empty prompt is [bos]
        short = InferenceRequest("", MAX_TOKENS)
        (reused,) = engine.infer_batch([short])
        fresh_engine = TorchLocalEngine(task.model, n_slots=N_SLOTS,
                                        max_len=MAX_LEN, device="cuda",
                                        params=params)
        fresh_engine.initialize()
        # the tokenizer decodes through its own memory of the words it
        # encoded: share it, so that the two texts compare token for token
        fresh_engine._tokenizer = engine._tokenizer
        (fresh,) = fresh_engine.infer_batch([short])
        require(reused.input_tokens == 1 and reused.text == fresh.text
                and reused.output_tokens == fresh.output_tokens,
                f"reused slot: {reused.text!r} vs fresh engine {fresh.text!r}")
        fresh_engine.shutdown()
        del fresh_engine
        log(f"slot reuse: a 1-token prompt in a slot that held a "
            f"{fs.prompt_len}-token prompt gives the fresh engine's "
            f"{fresh.output_tokens} tokens")

        prompt = engine._tokenizer.encode(render(fs.template, rows[0]))
        for length in (len(prompt), 2):
            handoff_gate(torch, b, prompt, length)

        toks = torch.tensor([prompt], device="cuda")
        step_breakdown(torch, f"mamba2 prefill ({len(prompt)} tokens into slot 0)",
                       lambda: b.model.prefill(b.params, toks, b.cache, 0))
        nxt = torch.full((N_SLOTS, 1), 7, dtype=torch.int64, device="cuda")
        pos = torch.zeros((N_SLOTS,), dtype=torch.int64, device="cuda")
        step_breakdown(torch, f"mamba2 decode step (batch {N_SLOTS})",
                       lambda: b.model.decode_step(b.params, nxt, b.cache, pos))
        log(f"phase 4 {serving_clean(session, 'phase 4')}")
    del params
    free_cuda(torch)
    return launches


# -- phase 6: the comparison path -------------------------------------------------

#: phase 6's kernels: prefill and decode for qwen3-4b, the SSD scan for
#: mamba2-2.7b, the bootstrap partials of the streaming task, BERTScore in
#: the rescore
SUITE_KERNELS = ("flash_attention", "decode_attention", "bootstrap_partials",
                 "bertscore_pr", "ssd")
SUITE_MODELS = ("qwen3-4b", "mamba2-2.7b")
SUITE_METRICS = (("exact_match", "lexical"), ("token_f1", "lexical"),
                 ("embedding_similarity", "semantic"))
#: the single-flight gate: N_ROWS rows cycling over this many prompts
DISTINCT = 16


def zero_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in counters().items()}


def same_result(torch, a, b) -> bool:
    """Two runs of one job gave the same texts, scores, metrics and
    streaming state, bit for bit."""
    import numpy as np

    if a.responses != b.responses or set(a.scores) != set(b.scores):
        return False
    if any(not np.array_equal(a.scores[k], b.scores[k]) for k in a.scores):
        return False
    if {k: (v.value, v.ci, v.n) for k, v in a.metrics.items()} != \
            {k: (v.value, v.ci, v.n) for k, v in b.metrics.items()}:
        return False
    sa, sb = a.stream_stats, b.stream_stats
    if (sa is None) != (sb is None):
        return False
    if sa is not None:
        if {k: (c.n, c.total, c.total_sq) for k, c in sa.accs.items()} != \
                {k: (c.n, c.total, c.total_sq) for k, c in sb.accs.items()}:
            return False
        if not (np.array_equal(sa.engine.sum_wx, sb.engine.sum_wx)
                and np.array_equal(sa.engine.sum_w, sb.engine.sum_w)):
            return False
    return True


class JobClock:
    """Middleware: each task's (model, start, end) on the host clock, so a
    parallel suite can show how long both engines' jobs ran at once."""

    def __init__(self):
        self.open: dict[int, float] = {}
        self.spans: list[tuple[str, str, float, float]] = []

    def on_task_start(self, task, rows, session) -> None:
        import threading

        self.open[threading.get_ident()] = time.perf_counter()

    def on_stage_start(self, stage, art, session) -> None:
        pass

    def on_stage_end(self, stage, art, session) -> None:
        pass

    def on_chunk_end(self, chunk_index, state, session) -> None:
        pass

    def on_task_end(self, task, result, session) -> None:
        import threading

        t0 = self.open.pop(threading.get_ident())
        self.spans.append((task.model.model_name, task.task_id, t0,
                           time.perf_counter()))

    def _union(self, model: str) -> list[tuple[float, float]]:
        out: list[list[float]] = []
        for s, e in sorted((s, e) for m, _, s, e in self.spans if m == model):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [tuple(x) for x in out]

    def overlap_s(self, a: str, b: str) -> float:
        """Seconds during which some job of model ``a`` and some job of
        model ``b`` were running."""
        return sum(max(0.0, min(e1, e2) - max(s1, s2))
                   for s1, e1 in self._union(a) for s2, e2 in self._union(b))


def cmp_key(c) -> tuple:
    return (c.test.test, c.test.statistic, c.test.p_value, c.diff, c.diff_ci,
            c.effect.value, c.recommendation.test, c.n)


def suite_gates(torch, suite, res) -> None:
    """The significance matrix: a Comparison for every metric the models
    share, p-values in [0, 1]; in memory the recommendation is
    ``recommend_test``'s on the card's own score vectors, and
    ``compare_scores`` rerun on the CPU from those scores gives the same
    test, statistic, p-value and effect bit for bit (the interval of the
    difference is the card's ``compute_ci``, logged beside the CPU's); in
    streaming the test is the paired bootstrap over kernel 6's replicates."""
    import numpy as np

    from repro_torch.core import compare_scores
    from repro_torch.stats.select import recommend_test

    pair = tuple(SUITE_MODELS)
    names = {m for m, _ in SUITE_METRICS}
    for task_id in res.tasks:
        cells = res.comparisons[task_id]
        require(set(cells) == names, f"{task_id}: comparisons for {sorted(cells)}")
        for metric, by_pair in cells.items():
            c = by_pair[pair]
            require(0.0 <= c.test.p_value <= 1.0 and math.isfinite(c.test.statistic),
                    f"{task_id} {metric}: p {c.test.p_value}, statistic "
                    f"{c.test.statistic}")
            log(f"phase 6 {task_id} {c.summary()}")
            if task_id.endswith("stream"):
                eng = res.results[(pair[0], task_id)].stream_stats.engine
                require(c.test.test == "paired_bootstrap"
                        and c.test.detail["backend"] == "device"
                        and eng.stream_id() == "device-kernel",
                        f"{task_id} {metric}: {c.test.test} from "
                        f"{c.test.detail} ({eng.stream_id()})")
                continue
            a, b = (res.results[(m, task_id)].scores[metric] for m in pair)
            keep = ~(np.isnan(a) | np.isnan(b))
            rec = recommend_test(a[keep], b[keep])
            require((rec.test, rec.reason) == (c.recommendation.test,
                                               c.recommendation.reason),
                    f"{task_id} {metric}: recommended {c.recommendation} on the "
                    f"card, {rec} from its scores")
            st = suite._tasks[0][0].statistics
            cpu = compare_scores(metric, a, b, confidence=st.confidence_level,
                                 n_boot=st.bootstrap_iterations, seed=st.seed,
                                 device="cpu")
            require((cpu.test.test, cpu.test.statistic, cpu.test.p_value,
                     cpu.effect.value, cpu.diff)
                    == (c.test.test, c.test.statistic, c.test.p_value,
                        c.effect.value, c.diff),
                    f"{task_id} {metric}: the CPU's {cpu.test} / {cpu.effect} "
                    f"against the card's {c.test} / {c.effect}")
            log(f"phase 6 {task_id} {metric}: {c.test.test} p={c.test.p_value!r} "
                f"equals the CPU's bit for bit; diff CI on the card "
                f"{c.diff_ci!r}, on the CPU {cpu.diff_ci!r}")


def suite_phase(torch) -> tuple[dict[str, int], dict[str, dict[str, int]]]:
    """Phase 6: one session holding full-width qwen3-4b and mamba2-2.7b
    (random bf16 weights from seed 0) on the card; ``run_suite`` over both
    models x an in-memory task and a streaming task (chunks of 16,
    ``backend="device"``, percentile) with two lexical metrics and the
    cosine metric; the same suite with ``parallel_jobs=2`` against the
    serial run; the response cache (a second run with no engine call, then
    ``CacheMiss`` under ``REPLAY``); ``rescore_stages`` with BERTScore; and
    single-flight over repeated prompts; then phase 8 in the same session.
    Returns phase 6's launches and phase 8's."""
    import tempfile
    import threading

    from repro_torch.core import (
        CacheMiss,
        CachePolicy,
        EngineModelConfig,
        EvalSession,
        EvalSuite,
        EvalTask,
        InferenceConfig,
        MetricConfig,
        StatisticsConfig,
        rescore_stages,
    )
    from repro_torch.data import iter_qa_examples, render

    t_phase = time.perf_counter()
    models = [EngineModelConfig(provider="torch_local", model_name=name,
                                reduced=False, seed=0, max_tokens=MAX_TOKENS)
              for name in SUITE_MODELS]
    metrics = tuple(MetricConfig(m, type=t) for m, t in SUITE_METRICS)
    mem = EvalTask("suite-mem", model=models[0], metrics=metrics,
                   statistics=StatisticsConfig(bootstrap_iterations=N_BOOT))
    stream = EvalTask(
        "suite-stream", model=models[0], metrics=metrics,
        statistics=StatisticsConfig(bootstrap_iterations=N_BOOT,
                                    ci_method="percentile", backend="device"),
    ).with_streaming(max_memory_rows=CHUNK)
    rows = list(iter_qa_examples(N_ROWS, seed=0))
    suite = (EvalSuite("phase-6").add_task(mem, rows)
             .add_task(stream, lambda: iter_qa_examples(N_ROWS, seed=0))
             .sweep_models(models))

    # a thread other than the main one launches on the same stream, so the
    # kernels' per-(device, stream) workspaces serve the batcher threads
    main_stream = torch.cuda.current_stream().cuda_stream
    seen: list[int] = []
    t = threading.Thread(target=lambda: seen.append(torch.cuda.current_stream().cuda_stream))
    t.start()
    t.join()
    require(seen == [main_stream], f"a new thread's stream {seen} is not the main "
            f"thread's {main_stream}")

    torch.cuda.reset_peak_memory_stats()
    engine_kwargs = {"n_slots": N_SLOTS, "max_len": MAX_LEN}
    clock = JobClock()
    with EvalSession(device="cuda", engine_kwargs=engine_kwargs,
                     middleware=[clock]) as session:
        t0 = time.perf_counter()
        for m in models:
            session.engine_for(m, mem.inference)
        torch.cuda.synchronize()
        log(f"phase 6: both engines on the card in {time.perf_counter() - t0:.3f} s, "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        zero_counts()
        phase_launches = read_counts()

        t0 = time.perf_counter()
        serial = session.run_suite(suite)
        torch.cuda.synchronize()
        serial_s = time.perf_counter() - t0
        launches = read_counts()
        mem_serial_s = sum(e - s for _, task_id, s, e in clock.spans
                           if task_id == mem.task_id)
        log(f"phase 6 suite (2 models x 2 tasks, serial): wall {serial_s:.3f} s, "
            f"launches {launches}, "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB peak allocated")
        for name in ("flash_attention", "decode_attention", "bootstrap_partials", "ssd"):
            require(launches[name] > 0, f"phase 6 suite: {name} was not launched")
        for (model, task_id), r in serial.results.items():
            require(r.failures == [] and r.engine_stats["calls"] == N_ROWS,
                    f"{model} {task_id}: failures {r.failures[:3]}, "
                    f"engine stats {r.engine_stats}")
            for name, mv in r.metrics.items():
                require(mv.n == N_ROWS and math.isfinite(mv.value),
                        f"{model} {task_id} {name}: {mv}")
            log(f"phase 6 {model} {task_id}: throughput {r.throughput_per_min:.1f} "
                f"examples/min (infer {r.timing['infer_s']:.3f} s)")
        t0 = time.perf_counter()
        suite_gates(torch, suite, serial)
        log(f"phase 6 significance gates: {time.perf_counter() - t0:.3f} s")

        # in parallel: suite.jobs() groups the jobs by model, so with two
        # workers a model's two tasks run together (their identical prompts
        # share flights in its service); the in-memory task alone over both
        # models, two workers, has both engines' batcher threads decoding at
        # once
        mem_suite = EvalSuite("phase-6-mem").add_task(mem, rows).sweep_models(models)
        for label, run_suite, engines_at_once in (
                ("suite, parallel_jobs=2", suite, False),
                ("in-memory task over both models, parallel_jobs=2", mem_suite, True)):
            before = read_counts()
            clock.spans.clear()
            t0 = time.perf_counter()
            parallel = session.run_suite(run_suite, parallel_jobs=2)
            torch.cuda.synchronize()
            parallel_s = time.perf_counter() - t0
            par_launches = {k: v - before[k] for k, v in read_counts().items()}
            both = clock.overlap_s(*SUITE_MODELS)
            log(f"phase 6 {label}: wall {parallel_s:.3f} s (serially: the suite "
                f"{serial_s:.3f} s, its in-memory jobs {mem_serial_s:.3f} s); the "
                f"two engines' jobs ran at once for {both:.3f} s; launches "
                f"{par_launches}")
            if engines_at_once:
                require(both > 0.0, f"{label}: the two engines never ran at once")
            t0 = time.perf_counter()
            for key, q in parallel.results.items():
                require(same_result(torch, serial.results[key], q),
                        f"{key}: {label} differs from the serial suite")
                log(f"phase 6 {key[0]} {key[1]} ({label}): throughput "
                    f"{q.throughput_per_min:.1f} examples/min, engine calls "
                    f"{q.engine_stats['calls']}, coalesced "
                    f"{q.engine_stats['coalesced']}")
            for task_id, cells in parallel.comparisons.items():
                for metric, by_pair in cells.items():
                    for p, c in by_pair.items():
                        require(cmp_key(c) == cmp_key(serial.comparisons[task_id][metric][p]),
                                f"{task_id} {metric}: {label} comparison differs")
            log(f"phase 6 {label} == serial (texts, scores, metrics, streaming "
                f"state, comparisons) checked in {time.perf_counter() - t0:.3f} s")

        # the response cache: a second run replays every answer
        with tempfile.TemporaryDirectory() as cache_dir:
            cached = dataclasses.replace(
                mem, task_id="suite-cache",
                inference=InferenceConfig(cache_dir=cache_dir))
            t0 = time.perf_counter()
            first = session.run_task(rows, cached)
            first_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            again = session.run_task(rows, cached)
            again_s = time.perf_counter() - t0
            require(first.engine_stats["calls"] == N_ROWS
                    and first.cache_stats["writes"] == N_ROWS,
                    f"cache: first run {first.engine_stats} {first.cache_stats}")
            require(again.engine_stats["calls"] == 0
                    and again.cache_stats["hits"] == N_ROWS
                    and again.cache_stats["misses"] == 0,
                    f"cache: second run {again.engine_stats} {again.cache_stats}")
            require(same_result(torch, first, again)
                    and first.responses == serial.results[(SUITE_MODELS[0], "suite-mem")].responses,
                    "cache: the replayed run differs from the first")
            replay = dataclasses.replace(cached, inference=InferenceConfig(
                cache_dir=cache_dir, cache_policy=CachePolicy.REPLAY))
            try:
                session.run_task(rows + [{"question": "a prompt never cached?",
                                          "reference": "none"}], replay)
                raise CheckFailed("REPLAY with a new prompt did not raise CacheMiss")
            except CacheMiss as e:
                log(f"phase 6 cache: REPLAY of a new prompt raised CacheMiss ({e})")
        log(f"phase 6 cache: first run {first_s:.3f} s ({N_ROWS} engine calls), "
            f"replay {again_s:.3f} s (0 engine calls, {N_ROWS} hits)")

        # rescoring: new metrics over the cached answers, no engine call
        calls = session.accounting.engine_calls
        before = read_counts()
        rescored_task = mem.with_metrics(*metrics, MetricConfig("bertscore", type="semantic"))
        t0 = time.perf_counter()
        rescored = session.run_task(rows, rescored_task,
                                    stages=rescore_stages(first.responses))
        torch.cuda.synchronize()
        rescore_s = time.perf_counter() - t0
        bert = read_counts()["bertscore_pr"] - before["bertscore_pr"]
        require(session.accounting.engine_calls == calls
                and rescored.engine_stats["calls"] == 0,
                f"rescore made {session.accounting.engine_calls - calls} engine calls")
        require(bert > 0, "rescore: bertscore_pr was not launched")
        for name, mv in first.metrics.items():
            got = rescored.metrics[name]
            require((got.value, got.ci) == (mv.value, mv.ci),
                    f"rescore: {name} {got} against {mv}")
        require(math.isfinite(rescored.metrics["bertscore"].value), "rescore: bertscore")
        log(f"phase 6 rescore: {rescore_s:.3f} s, 0 engine calls, {bert} bertscore_pr "
            f"launch(es), bertscore {rescored.metrics['bertscore']}")

        # single-flight: 64 rows over 16 prompts
        dups = [dict(rows[i % DISTINCT]) for i in range(N_ROWS)]
        t0 = time.perf_counter()
        flight = session.run_task(dups, dataclasses.replace(mem, task_id="suite-dups"))
        flight_s = time.perf_counter() - t0
        want = {"calls": DISTINCT, "total_cost": 0.0,
                "coalesced": N_ROWS - DISTINCT, "pool": {}}
        require(flight.engine_stats == want,
                f"single-flight: {flight.engine_stats}, not {want}")
        log(f"phase 6 single-flight: {N_ROWS} rows over {DISTINCT} prompts in "
            f"{flight_s:.3f} s: {DISTINCT} engine calls, {N_ROWS - DISTINCT} coalesced")
        serving = session.serving_stats()
        log(f"phase 6 services: " + "; ".join(
            f"{s['engine']} submitted {s['submitted']} dispatched {s['dispatched']} "
            f"coalesced {s['coalesced']} restarts {s['restarts']} errors {s['errors']}"
            for s in serving))
        serving_clean(session, "phase 6")
        log(f"phase 6 accounting: {session.accounting.as_dict()}")
        phase_launches = read_counts()
        log(f"phase 6 launches: {phase_launches}; "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB peak allocated")
        for name in SUITE_KERNELS:
            require(phase_launches[name] > 0, f"phase 6: {name} was not launched")
        log(f"phase 6 took {time.perf_counter() - t_phase:.1f} s")

        # phase 8 compares runs over up to QA_ROWS prompts bit for bit, which
        # holds once the engines' tokenizers have encoded every one of them
        # (a text is the decode of its tokens through the words encoded)
        for m in models:
            tok = session.engine_for(m, mem.inference).tokenizer
            for r in iter_qa_examples(QA_ROWS, seed=0):
                tok.encode(render(mem.data.prompt_template, r))
        t0 = time.perf_counter()
        streaming = streaming_phase(torch, session, models, metrics)
        log(f"phase 8 took {time.perf_counter() - t0:.1f} s; "
            f"{serving_clean(session, 'phases 6 and 8')}")
    return phase_launches, streaming


#: phase 7: its rows (two chunks: the lock-step path keeps two prompts in
#: flight where the service keeps 16, and a judged row costs four prompts,
#: so phase 7 takes half of phase 2's rows to keep the whole script within
#: half of its 20-minute budget); the lock-step path's workers and prompts
#: a shard (two shards a chunk, so both workers are busy streaming too); the RAG
#: task's metrics (name, type) and those of them that a judge grades; the
#: sampling temperature; the relative gap under which a sampled slot's top
#: two scores count as a tie
PHASE7_ROWS = CHUNK
LOCKSTEP_WORKERS, LOCKSTEP_SHARD = 2, 8
#: phase 7 (a)'s rows on both paths: one chunk of two shards (a lock-step
#: run of 32 rows took ~40 s, which pushed the whole script past 600 s)
LOCKSTEP_ROWS = CHUNK
RAG_METRICS = (("llm_judge", "llm_judge"), ("faithfulness", "rag"),
               ("context_relevance", "rag"), ("answer_relevance", "rag"),
               ("context_precision", "rag"), ("context_recall", "rag"),
               ("exact_match", "lexical"))
JUDGED = ("llm_judge", "faithfulness", "context_relevance")
TEMPERATURE = 0.7
NEAR_TIE = 1e-5
#: full-width qwen3-4b layers: one prefill-kernel launch a layer a prompt,
#: one decode-kernel launch a layer a decode step
QWEN_LAYERS = 36


class StageLaunches:
    """Middleware: each stage's kernel launches in an in-memory run, so the
    task's prompts (the infer stage) and a judge's (the metrics stage) are
    counted apart."""

    def __init__(self):
        self.by_stage: dict[str, dict[str, int]] = {}
        self._start: dict[str, int] = {}

    def on_task_start(self, task, rows, session) -> None:
        self.by_stage = {}

    def on_stage_start(self, stage, art, session) -> None:
        import torch

        torch.cuda.synchronize()
        self._start = read_counts()

    def on_stage_end(self, stage, art, session) -> None:
        import torch

        torch.cuda.synchronize()
        now = read_counts()
        self.by_stage[stage.name] = {k: now[k] - self._start[k] for k in now}

    def on_chunk_end(self, chunk_index, state, session) -> None:
        pass

    def on_task_end(self, task, result, session) -> None:
        pass


def counted_run(torch, session, rows, task, label: str):
    """``run_task`` with every launch count set to 0 just before and read
    just after; logs the wall, the engine calls and the launches.  Returns
    (result, launches)."""
    zero_counts()
    t0 = time.perf_counter()
    result = session.run_task(rows, task)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    log(f"{label}: run_task wall {wall:.3f} s, {result.engine_stats['calls']} "
        f"engine calls, launches {launches}; {serving_clean(session, label)}")
    return result, launches


def nan_metric(mv) -> bool:
    """The reference's result for a metric no example could score."""
    return (math.isnan(mv.value) and all(math.isnan(x) for x in mv.ci)
            and mv.ci_method == "none" and mv.n == 0 and mv.n_unscored == PHASE7_ROWS)


def lockstep_gates(torch, session, task):
    """Phase 7 (a): phase 2's task on the lock-step path
    (``use_service=False``, two workers calling the engine one prompt at a
    time) in memory and streaming over ``LOCKSTEP_ROWS``, against the
    service path on the same rows (in memory, a fresh response cache
    each).  Returns the service path's in-memory result over the phase's
    ``PHASE7_ROWS``, the greedy texts (d) compares with, and phase 9's
    yardstick: the service path's tasks, results and walls over
    ``LOCKSTEP_ROWS``, and a copy of the engine's tokenizer as it decoded
    them."""
    import tempfile

    from repro_torch.core import InferenceConfig, StreamingConfig

    kernels = ("flash_attention", "decode_attention")
    run = functools.partial(timed_run_task, torch, session, n_rows=LOCKSTEP_ROWS)
    lock = InferenceConfig(use_service=False, n_workers=LOCKSTEP_WORKERS,
                           batch_size=LOCKSTEP_SHARD)
    greedy_task = dataclasses.replace(task, streaming=StreamingConfig())
    *_, greedy = timed_run_task(torch, session, greedy_task, kernels,
                                "phase 7 (a) service path in memory, the phase's rows",
                                n_rows=PHASE7_ROWS)
    with tempfile.TemporaryDirectory() as tmp:
        # the same shards on both paths: a shard's cache writes are one
        # table version
        mem = dataclasses.replace(greedy_task,
                                  inference=InferenceConfig(cache_dir=f"{tmp}/service",
                                                            batch_size=LOCKSTEP_SHARD))
        lock_mem = dataclasses.replace(mem, inference=dataclasses.replace(
            lock, cache_dir=f"{tmp}/lockstep"))
        *_, svc_wall, svc = run(mem, kernels, "phase 7 (a) service path in memory")
        *_, lm = run(lock_mem, kernels, "phase 7 (a) lock-step path in memory")
    kernels += ("bootstrap_partials",)
    *_, ss_wall, ss = run(task, kernels, "phase 7 (a) service path streaming")
    yard = {"in memory": (dataclasses.replace(mem, inference=InferenceConfig(
                batch_size=LOCKSTEP_SHARD)), svc, svc_wall),
            "streaming": (task, ss, ss_wall),
            "tokenizer": tokenizer_copy(session.engine_for(task.model,
                                                          task.inference).tokenizer)}
    *_, ls = run(dataclasses.replace(task, inference=lock), kernels,
                 "phase 7 (a) lock-step path streaming")

    def calls(r):
        return {k: v for k, v in r.engine_stats.items() if k != "pool"}

    # a shard is ``batch_size`` prompts of the rows in memory, or of a chunk
    bs = lock.batch_size
    shards = {"in memory": -(-LOCKSTEP_ROWS // bs),
              "streaming": LOCKSTEP_ROWS // CHUNK * -(-CHUNK // bs)}
    for label, got, want in (("in memory", lm, svc), ("streaming", ls, ss)):
        require(same_result(torch, got, want),
                f"lock-step {label}: texts, scores, metrics or streaming state "
                f"differ from the service path's")
        require(calls(got) == calls(want) and got.cache_stats == want.cache_stats,
                f"lock-step {label}: engine stats {got.engine_stats} cache "
                f"{got.cache_stats}, the service's {want.engine_stats} {want.cache_stats}")
        pool = got.engine_stats["pool"]
        require(pool.get("shards") == shards[label] and pool["failures"] == 0,
                f"lock-step {label}: pool stats {pool}")
        require(want.engine_stats["pool"] == {}, "the service path filled pool stats")
    require(lm.cache_stats["misses"] == lm.cache_stats["writes"] == LOCKSTEP_ROWS,
            f"lock-step in memory: cache {lm.cache_stats}")
    require(svc.responses == greedy.responses[:LOCKSTEP_ROWS],
            "the service path's texts depend on the rows run beside them")
    log(f"phase 7 (a): the lock-step path equals the service path bit for bit in "
        f"memory and streaming; engine stats {calls(lm)}, cache {lm.cache_stats}, "
        f"pool {lm.engine_stats['pool']} / {ls.engine_stats['pool']}")
    return greedy, yard


def tokenizer_copy(tok):
    """A copy of a tokenizer with its memory of the words it has encoded (an
    id it never encoded decodes as ``<id>``, and of two words with one id
    the first encoded wins): engines given copies render the same tokens as
    the same text."""
    from repro_torch.data import HashTokenizer

    out = HashTokenizer(tok.vocab_size)
    out._inverse = dict(tok._inverse)
    return out


def rag_task(base_task):
    from repro_torch.core import MetricConfig, StatisticsConfig, StreamingConfig

    return dataclasses.replace(
        base_task, task_id="rag-qwen3-4b", streaming=StreamingConfig(),
        metrics=tuple(MetricConfig(m, type=t) for m, t in RAG_METRICS),
        statistics=StatisticsConfig(bootstrap_iterations=N_BOOT, backend="device"))


def host_rag_scores(rows, texts) -> dict:
    """The non-judge metrics recomputed on the host from the card's texts."""
    from repro_torch.metrics import batch_lexical, rag

    qs = [r["question"] for r in rows]
    refs = [r["reference"] for r in rows]
    ctxs = [r["contexts"] for r in rows]
    return {
        "answer_relevance": rag.answer_relevance(qs, texts),
        "context_precision": rag.context_precision(ctxs, refs),
        "context_recall": rag.context_recall(ctxs, refs),
        "exact_match": batch_lexical("exact_match", texts, refs),
    }


def scored_range(name: str, mv) -> None:
    """A scored RAG metric: every example counted, the interval brackets the
    value (with phase 5's 1e-5 slack for the f32 replicate means) and lies
    in the metric's range: [-1, 1] for the cosine, the 1-5 scale for the
    judge's grade, [0, 1] otherwise."""
    lo, hi = mv.ci
    slack = 1e-5 * abs(mv.value)
    require(mv.n + mv.n_unscored == PHASE7_ROWS and lo - slack <= mv.value <= hi + slack,
            f"{name}: bad interval {mv}: ({lo!r}, {hi!r})")
    floor, ceil = {"answer_relevance": (-1.0, 1.0), "llm_judge": (1.0, 5.0)}.get(
        name, (0.0, 1.0))
    require(floor <= lo and hi <= ceil, f"{name}: outside [{floor}, {ceil}]: {mv}")


def judge_gates(torch, session, task):
    """Phase 7 (b): the RAG task on phase 2's engine, which is also the
    judge (the session has none), in memory and streaming
    (``backend="device"``).  Random weights never answer ``Score: n``, so
    every judge metric is the reference's empty result.  Returns the
    in-memory result and its stages' launches."""
    import numpy as np

    from repro_torch.data import rag_examples

    rows = rag_examples(PHASE7_ROWS)
    hot = rag_task(task)
    stages = StageLaunches()
    session.middleware.append(stages)
    try:
        res, _ = counted_run(torch, session, rows, hot,
                                "phase 7 (b) task engine as judge, in memory")
    finally:
        session.middleware.remove(stages)
    by_stage = stages.by_stage
    log(f"phase 7 (b) launches of the task's prompts {by_stage['infer']}, of the "
        f"judge's {by_stage['metrics']}")
    for part in ("infer", "metrics"):
        for k in ("flash_attention", "decode_attention"):
            require(by_stage[part][k] > 0, f"(b): no {k} launch in the {part} stage")
    require(len(res.logs["judge_unparseable"]) == PHASE7_ROWS,
            f"(b): {len(res.logs['judge_unparseable'])} unparseable judge answers "
            f"logged for {PHASE7_ROWS} rows")
    for name in JUDGED:
        require(np.isnan(res.scores[name]).all() and nan_metric(res.metrics[name]),
                f"(b): {name} is {res.metrics[name]}, not the empty result")
    for name, want in host_rag_scores(rows, res.responses).items():
        require(np.array_equal(res.scores[name], want),
                f"(b): {name} differs from the host's recomputation")
        scored_range(name, res.metrics[name])

    stream, launches = counted_run(
        torch, session, rows, hot.with_streaming(max_memory_rows=CHUNK),
        "phase 7 (b) task engine as judge, streaming (device backend)")
    require(launches["bootstrap_partials"] == PHASE7_ROWS // CHUNK,
            f"(b) streaming: {launches['bootstrap_partials']} bootstrap_partials "
            f"launches, not one a chunk")
    engine = stream.stream_stats.engine
    require(engine.stream_id() == "device-kernel", f"(b): {engine.stream_id()}")
    for name in JUDGED:
        require(nan_metric(stream.metrics[name])
                and not engine.view(name).sum_w.any(),
                f"(b) streaming: {name} is {stream.metrics[name]}, its replicate "
                f"weights sum to {engine.view(name).sum_w.max()}")
    for name in host_rag_scores(rows, res.responses):
        scored_range(name, stream.metrics[name])
    log("phase 7 (b): every judge answer unparseable; the judge metrics are the "
        "empty result in memory and streaming (kernel 6 gave them zero weight); "
        "the other RAG metrics equal the host's recomputation")
    return res, by_stage


def simulated_judge_gates(torch, params, task, task_res, task_launches):
    """Phase 7 (c): the RAG task on a fresh engine over phase 2's weights,
    graded by the simulated API judge: the card answers, the host judges."""
    import numpy as np

    from repro_torch.core import EngineModelConfig, EvalSession, SimulatedAPIEngine
    from repro_torch.data import rag_examples
    from repro_torch.metrics import MetricContext, resolve_metrics

    rows = rag_examples(PHASE7_ROWS)
    judge_model = EngineModelConfig(provider="openai", model_name="gpt-4o-mini")
    stages = StageLaunches()
    kw = {"n_slots": N_SLOTS, "max_len": MAX_LEN, "params": params}
    with EvalSession(device="cuda", judge_engine=SimulatedAPIEngine(judge_model),
                     engine_kwargs=kw, middleware=[stages]) as s:
        res, launches = counted_run(torch, s, rows, rag_task(task),
                                       "phase 7 (c) simulated judge")
        steps = s.engine_for(task.model, task.inference).serving_stats()["steps"]
    require(res.responses == task_res.responses,
            "(c): the card's answers differ from (b)'s")
    require(not any(stages.by_stage["metrics"].values()),
            f"(c): the judge stage launched kernels {stages.by_stage['metrics']}")
    b = task_launches
    require(launches["flash_attention"] == b["flash_attention"] == PHASE7_ROWS * QWEN_LAYERS,
            f"(c): {launches['flash_attention']} prefill launches, (b)'s task "
            f"{b['flash_attention']}")
    require(launches["decode_attention"] == steps * QWEN_LAYERS,
            f"(c): {launches['decode_attention']} decode launches for {steps} steps")
    log(f"phase 7 (c): launches {launches} against (b)'s task part {b} "
        f"(equal: {launches == b}); {steps} decode steps")
    ctx = MetricContext(judge_engine=SimulatedAPIEngine(judge_model),
                        device=torch.device("cpu"))
    for name, scorer in resolve_metrics(rag_task(task).metrics):
        want = np.asarray(scorer(rows, res.responses, ctx), np.float64)
        require(np.array_equal(res.scores[name], want, equal_nan=True),
                f"(c): {name} differs from the host's simulated judge")
    require(res.logs == ctx.logs, "(c): unparseable rows differ from the host's")
    grades = res.scores["llm_judge"][~np.isnan(res.scores["llm_judge"])]
    require(grades.size and ((grades >= 1) & (grades <= 5)).all(),
            f"(c): judge grades {grades}")
    for name, _ in RAG_METRICS:
        scored_range(name, res.metrics[name])
    log(f"phase 7 (c): {grades.size} of {PHASE7_ROWS} grades parsed in [1, 5], "
        f"{len(res.logs['judge_unparseable'])} unparseable; every score equals the "
        f"host's simulated judge over the card's texts; llm_judge "
        f"{res.metrics['llm_judge']}")


def sampling_gates(torch, params, task, greedy):
    """Phase 7 (d): phase 2's task in memory at ``TEMPERATURE`` twice, each
    in a fresh engine over phase 2's weights (the sampling key starts anew):
    equal texts, unlike the greedy run's; one decode step's sampled tokens
    against the host's argmax of the step's logits / T plus the CPU's
    threefry Gumbel noise under the same key."""
    import repro_torch.serve.steps as steps
    from repro_torch.core import EvalSession, InferenceConfig, StreamingConfig
    from repro_torch.data import iter_qa_examples
    from repro_torch.stats import threefry

    hot = dataclasses.replace(
        task, task_id="qa-qwen3-4b-sampled", streaming=StreamingConfig(),
        model=dataclasses.replace(task.model, temperature=TEMPERATURE),
        # a fresh service: every prompt is queued before the first step, so
        # both runs decode on one schedule
        inference=InferenceConfig(max_batch_wait_ms=100.0))
    real = steps.temperature_sample
    logged: list = []
    calls = [0]

    def logging_sample(logits, vocab_size, temperature, key):
        # the fifth decode step of the first run, with every slot busy
        out = real(logits, vocab_size, temperature, key)
        calls[0] += 1
        if calls[0] == 5:
            logged.append((logits.float().cpu(), key.cpu(), out.cpu(), vocab_size))
        return out

    texts = []
    kw = {"n_slots": N_SLOTS, "max_len": MAX_LEN, "params": params}
    for turn in range(2):
        steps.temperature_sample = logging_sample if turn == 0 else real
        try:
            # a wall-clock session: the service's 100 ms batch window
            # sleeps through the session's sleep
            with EvalSession(device="cuda", engine_kwargs=kw,
                             wall_clock_rate_limit=True) as s:
                res, launches = counted_run(
                    torch, s, iter_qa_examples(PHASE7_ROWS, seed=0), hot,
                    f"phase 7 (d) temperature {TEMPERATURE}, run {turn + 1}")
        finally:
            steps.temperature_sample = real
        for k in ("flash_attention", "decode_attention"):
            require(launches[k] > 0, f"(d): {k} was not launched")
        texts.append(res.responses)
    require(texts[0] == texts[1], "(d): two fresh engines sampled different texts")
    require(texts[0] != greedy.responses, "(d): the sampled texts are the greedy ones")
    changed = sum(a != b for a, b in zip(texts[0], greedy.responses))

    logits, key, sampled, vocab = logged[0]
    t = torch.tensor(TEMPERATURE, dtype=torch.float32)
    pad = torch.arange(logits.shape[-1]) >= vocab
    scores = threefry.gumbel(key, tuple(logits.shape)) + logits.masked_fill(
        pad, float("-inf")) / t
    host = scores.argmax(-1)
    top2 = scores.topk(2, dim=-1).values
    near = (top2[:, 0] - top2[:, 1]).abs() <= NEAR_TIE * top2[:, 0].abs()
    bad = (host != sampled) & ~near
    require(not bad.any(), f"(d): slots {bad.nonzero().flatten().tolist()} sampled "
            f"{sampled[bad].tolist()}, the host's argmax {host[bad].tolist()}")
    log(f"phase 7 (d): two fresh engines sampled equal texts at T={TEMPERATURE}, "
        f"{changed} of {PHASE7_ROWS} unlike the greedy run's; the logged decode step's "
        f"{sampled.numel()} sampled tokens equal the host's argmax of logits / T + "
        f"threefry Gumbel noise ({int(near.sum())} near ties exempt, "
        f"{int((host == sampled).sum())} equal)")


def harness_phase(torch, session, task):
    """Phase 7, the harness around inference, in phase 2's session on its
    full-width qwen3-4b engine (no new weights): (a) the lock-step path,
    (b) the task's own engine as judge of the RAG task, (c) a simulated
    judge beside the card's answers, (d) temperature sampling.  Returns
    (b)'s launches by stage and phase 9's yardstick from (a)."""
    t0 = time.perf_counter()
    greedy, yard = lockstep_gates(torch, session, task)
    t_a = time.perf_counter()
    res_b, by_stage = judge_gates(torch, session, task)
    t_b = time.perf_counter()
    params = session.engine_for(task.model, task.inference).batcher.params
    simulated_judge_gates(torch, params, task, res_b, by_stage["infer"])
    t_c = time.perf_counter()
    sampling_gates(torch, params, task, greedy)
    t_d = time.perf_counter()
    log(f"phase 7 walls: (a) {t_a - t0:.1f} s, (b) {t_b - t_a:.1f} s, "
        f"(c) {t_c - t_b:.1f} s, (d) {t_d - t_c:.1f} s; {t_d - t0:.1f} s in all")
    return by_stage, yard


# -- phase 8: streaming at scale -------------------------------------------------

#: phase 8's sources: (a) and (b) three chunks, (c) four; (d) draws from
#: QA_ROWS; the budget of (d) in scored examples, its seed round
#: and its round size
STREAM_ROWS, STOP_ROWS = 3 * CHUNK, QA_ROWS
BUDGET_TOTAL, BUDGET_MIN, BUDGET_ROUND = 6 * CHUNK, CHUNK, CHUNK
#: kernel 6 launches a live chunk: one per group of 8 metric columns
PARTIALS_PER_CHUNK = -(-len(SUITE_METRICS) // 8)
STREAM_KERNELS = ("flash_attention", "decode_attention", "bootstrap_partials")


class TextDigests:
    """Context manager: a digest of each chunk's texts, keyed by a digest of
    its rows, as the score stage sees them (a streaming result drops its
    texts).  Chunk workers of a concurrent run record from their threads."""

    def __enter__(self):
        import hashlib

        from repro_torch.core.stages import ScoreStage

        self.digests: dict[str, str] = {}
        self._cls, self._run = ScoreStage, ScoreStage.run
        digests, orig = self.digests, self._run

        def run(stage, art, session):
            rows = hashlib.sha256(json.dumps(art.rows, sort_keys=True).encode())
            digests[rows.hexdigest()] = hashlib.sha256(
                "\x1f".join(art.texts).encode()).hexdigest()
            return orig(stage, art, session)

        ScoreStage.run = run
        return self

    def __exit__(self, *exc) -> None:
        self._cls.run = self._run


class RunLog:
    """Middleware: each finished task's model, resumed and total chunks and
    the engine calls it made (the rounds of an adaptive suite; a result's
    ``engine_stats`` also counts the calls of its resumed chunks)."""

    def __init__(self):
        self.runs: list[tuple[str, int, int, int]] = []
        self._calls = 0

    def on_task_start(self, task, rows, session) -> None:
        self._calls = session.accounting.engine_calls

    def on_stage_start(self, stage, art, session) -> None:
        pass

    def on_stage_end(self, stage, art, session) -> None:
        pass

    def on_chunk_end(self, chunk_index, state, session) -> None:
        pass

    def on_task_end(self, task, result, session) -> None:
        st = result.logs["streaming"]
        self.runs.append((task.model.model_name, st["n_resumed_chunks"],
                          st["n_chunks"], session.accounting.engine_calls - self._calls))


def stream_run(torch, session, task, n_rows: int, label: str, crash=None):
    """``run_task`` over ``n_rows`` QA rows with every launch count set to
    0 just before and read just after; with ``crash`` (a
    ``ChunkCrashMiddleware``) the run must die of its ``SimulatedCrash``.
    Logs the wall, the engine calls and the launches; returns (result or
    None, launches, engine calls)."""
    from repro_torch.data import iter_qa_examples
    from repro_torch.ft import SimulatedCrash

    calls = session.accounting.engine_calls
    zero_counts()
    t0 = time.perf_counter()
    result = None
    if crash is None:
        result = session.run_task(iter_qa_examples(n_rows, seed=0), task)
    else:
        session.middleware.append(crash)
        try:
            session.run_task(iter_qa_examples(n_rows, seed=0), task)
            raise CheckFailed(f"phase 8 {label}: the injected crash did not fire")
        except SimulatedCrash as e:
            log(f"phase 8 {label}: {e}")
        finally:
            session.middleware.remove(crash)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    calls = session.accounting.engine_calls - calls
    shown = {k: v for k, v in launches.items() if v}
    extra = ""
    if result is not None:
        st = {k: v for k, v in result.logs["streaming"].items() if k != "spill_dir"}
        extra = f"; streaming {st}"
        if "adaptive" in result.logs:
            extra += f"; adaptive {result.logs['adaptive']}"
    log(f"phase 8 {label}: wall {wall:.3f} s, {calls} engine calls, launches "
        f"{shown}{extra}; {serving_clean(session, f'phase 8 {label}')}")
    return result, launches, calls


def launched(launches: dict[str, int], label: str, **want: int) -> None:
    """Each named kernel launched exactly that many times."""
    got = {k: launches[k] for k in want}
    require(got == want, f"phase 8 {label}: launches {got}, not {want}")


def resume_phase(torch, session, task, tmp: str):
    """Phase 8 (a): spill, crash and resume on qwen3-4b.  Returns the
    uninterrupted run, its texts' digests and the resumed run's launches."""
    from repro_torch.ft import ChunkCrashMiddleware, Fault

    per_prompt = QWEN_LAYERS  # one prefill launch of kernel 1 a layer
    with TextDigests() as ref_texts:
        ref, launches, calls = stream_run(
            torch, session, task.with_streaming(spill_dir=f"{tmp}/ref"),
            STREAM_ROWS, "(a) uninterrupted")
    require(calls == STREAM_ROWS and len(ref_texts.digests) == STREAM_ROWS // CHUNK,
            f"(a) uninterrupted: {calls} engine calls, {len(ref_texts.digests)} chunks")
    launched(launches, "(a) uninterrupted", flash_attention=STREAM_ROWS * per_prompt,
             bootstrap_partials=STREAM_ROWS // CHUNK * PARTIALS_PER_CHUNK)
    require(ref.stream_stats.engine.stream_id() == "device-kernel",
            f"(a): stream {ref.stream_stats.engine.stream_id()}")

    spilled = task.with_streaming(spill_dir=f"{tmp}/crash")
    crash = ChunkCrashMiddleware([Fault(shard=1, attempt=1)])
    _, launches, calls = stream_run(torch, session, spilled, STREAM_ROWS,
                                    "(a) crash after chunk 1", crash=crash)
    require(calls == 2 * CHUNK and crash.injected == [(1, 1, "raise")],
            f"(a) crash: {calls} engine calls, injected {crash.injected}")

    with TextDigests() as texts:
        res, resumed, calls = stream_run(torch, session, spilled, STREAM_ROWS,
                                         "(a) resumed")
    st = res.logs["streaming"]
    require(st["n_resumed_chunks"] == 2 and st["n_chunks"] == 3 and calls == CHUNK,
            f"(a) resumed: {st['n_resumed_chunks']} resumed chunks, {calls} engine calls")
    launched(resumed, "(a) resumed", flash_attention=CHUNK * per_prompt,
             bootstrap_partials=PARTIALS_PER_CHUNK)
    require(resumed["decode_attention"] > 0, "(a) resumed: decode_attention not launched")
    require(same_result(torch, res, ref) and res.engine_stats == ref.engine_stats,
            "(a) resumed: metrics, streaming state or engine stats differ from the "
            "uninterrupted run")
    require(len(texts.digests) == 1
            and texts.digests.items() <= ref_texts.digests.items(),
            "(a) resumed: chunk 2's texts differ from the uninterrupted run's")

    again, launches, calls = stream_run(torch, session, spilled, STREAM_ROWS,
                                        "(a) resume of the finished run")
    require(calls == 0 and again.logs["streaming"]["n_resumed_chunks"] == 3,
            f"(a) again: {calls} engine calls")
    launched(launches, "(a) again", flash_attention=0, decode_attention=0,
             bootstrap_partials=0)
    require(same_result(torch, again, ref), "(a) again: result differs")
    log("phase 8 (a): the resumed run ran chunk 2 alone and equals the "
        "uninterrupted run bit for bit; a second resume launched nothing")
    return ref, ref_texts.digests, resumed


def concurrent_phase(torch, session, task, ref, ref_texts) -> None:
    """Phase 8 (b): two chunks in flight through one batcher."""
    conc = task.with_streaming(concurrency=2)
    with TextDigests() as texts:
        res, launches, calls = stream_run(torch, session, conc, STREAM_ROWS,
                                          "(b) max_inflight_chunks=2")
    st = res.logs["streaming"]
    launched(launches, "(b)", flash_attention=STREAM_ROWS * QWEN_LAYERS,
             bootstrap_partials=STREAM_ROWS // CHUNK * PARTIALS_PER_CHUNK)
    require(same_result(torch, res, ref) and texts.digests == ref_texts,
            "(b): metrics, streaming state or texts differ from (a)'s uninterrupted run")
    require(res.engine_stats == ref.engine_stats and calls == STREAM_ROWS,
            f"(b): engine stats {res.engine_stats}, (a)'s {ref.engine_stats}")
    pool = st["chunk_pool"]
    require(st["max_inflight_chunks"] == 2 and st["max_resident_rows"] <= 2 * CHUNK
            and pool["shards"] == STREAM_ROWS // CHUNK and pool["failures"] == 0,
            f"(b): streaming log {st}")
    log(f"phase 8 (b): bit for bit (a)'s texts, metrics, streaming state and "
        f"engine stats; at most {st['max_resident_rows']} rows resident; chunk "
        f"pool {pool}")


def stopping_phase(torch, session, task, tmp: str, ref) -> None:
    """Phase 8 (c): early stopping, a declared sampling cap and a width rule."""
    from repro_torch.stats import MetricAccumulator
    from repro_torch.stats.sequential import StoppingRule

    capped = task.with_streaming(spill_dir=f"{tmp}/cap").with_stopping(
        max_examples=2 * CHUNK, min_examples=CHUNK)
    res, launches, calls = stream_run(torch, session, capped, STOP_ROWS,
                                      "(c) max_examples=32")
    ad = res.logs["adaptive"]
    require(ad["stopped"] and ad["reason"] == "max_examples" and ad["stop_chunk"] == 1
            and ad["n_examples"] == 2 * CHUNK and calls == 2 * CHUNK,
            f"(c) cap: {ad}, {calls} engine calls")
    launched(launches, "(c) cap", flash_attention=2 * CHUNK * QWEN_LAYERS)
    again, launches, calls = stream_run(torch, session, capped, STOP_ROWS,
                                        "(c) resume of the stopped run")
    require(calls == 0 and again.logs["adaptive"] == ad and same_result(torch, again, res),
            f"(c) replay: {calls} engine calls, {again.logs['adaptive']}")
    launched(launches, "(c) replay", flash_attention=0, decode_attention=0,
             bootstrap_partials=0)

    # exact_match is 0 on every random-weight answer (checked on (a)'s run),
    # so its interval's half-width depends on n alone: a target between the
    # widths at 32 and 48 rows fires after chunk 2 of 4
    acc = ref.stream_stats.accs["exact_match"]
    require(acc.total == 0.0 and acc.n == STREAM_ROWS,
            f"(c): exact_match is not 0 on every answer ({acc.total} of {acc.n})")
    rule = StoppingRule(enabled=True, metric="exact_match", min_examples=CHUNK)

    def width(n: int) -> float:
        zeros = MetricAccumulator()
        zeros.update([0.0] * n)
        return rule.ci(zeros).half_width

    target = (width(2 * CHUNK) + width(3 * CHUNK)) / 2
    log(f"phase 8 (c): exact_match half-widths {width(CHUNK)!r} / {width(2 * CHUNK)!r} "
        f"/ {width(3 * CHUNK)!r} at n = {CHUNK} / {2 * CHUNK} / {3 * CHUNK}; "
        f"target_half_width {target!r}")
    wide = task.with_streaming(spill_dir=f"{tmp}/width").with_stopping(
        metric="exact_match", min_examples=CHUNK, target_half_width=target)
    res, launches, calls = stream_run(torch, session, wide, STOP_ROWS,
                                      "(c) width rule")
    ad = res.logs["adaptive"]
    require(ad["stopped"] and ad["reason"] == "target_half_width"
            and ad["stop_chunk"] == 2 and ad["n_examples"] == 3 * CHUNK
            and calls == 3 * CHUNK and ad["half_width"] == width(3 * CHUNK),
            f"(c) width: {ad}, {calls} engine calls")
    log("phase 8 (c): the cap stopped after chunk 1 and replayed with no engine "
        "call; the width rule stopped after chunk 2 of 4")


def adaptive_phase(torch, session, models, metrics, tmp: str) -> dict[str, int]:
    """Phase 8 (d): ``run_adaptive_suite`` over both engines, then a replay."""
    from repro_torch.core import (
        BudgetConfig,
        EvalSuite,
        EvalTask,
        StatisticsConfig,
        run_adaptive_suite,
    )
    from repro_torch.data import iter_qa_examples
    from repro_torch.stats.sequential import sequential_compare

    task = EvalTask(
        "phase-8-adaptive", model=models[0], metrics=metrics,
        statistics=StatisticsConfig(bootstrap_iterations=N_BOOT,
                                    ci_method="percentile", backend="device"),
    ).with_streaming(max_memory_rows=CHUNK, spill_dir=f"{tmp}/adaptive")
    suite = (EvalSuite("phase-8").add_task(task, lambda: iter_qa_examples(QA_ROWS, seed=0))
             .sweep_models(models))
    budget = BudgetConfig(total_examples=BUDGET_TOTAL, min_examples=BUDGET_MIN,
                          round_examples=BUDGET_ROUND)
    runs = RunLog()
    session.middleware.append(runs)
    try:
        out = {}
        for label in ("run", "replay"):
            runs.runs.clear()
            calls = session.accounting.engine_calls
            zero_counts()
            t0 = time.perf_counter()
            out[label] = run_adaptive_suite(session, suite, budget)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            out[label + " launches"] = read_counts()
            out[label + " calls"] = session.accounting.engine_calls - calls
            out[label + " runs"] = list(runs.runs)
            log(f"phase 8 (d) {label}: wall {wall:.3f} s, "
                f"{out[label + ' calls']} engine calls, launches "
                f"{ {k: v for k, v in out[label + ' launches'].items() if v} }; "
                f"rounds (model, resumed chunks, chunks, engine calls) {runs.runs}")
    finally:
        session.middleware.remove(runs)
    res, payload = out["run"], out["run"].adaptive
    log(f"phase 8 (d) adaptive payload: {payload}")
    # every round after an arm's first resumes all of its earlier chunks
    for model in SUITE_MODELS:
        seq = [r for r in out["run runs"] if r[0] == model]
        prev = 0
        for _, resumed, chunks, calls in seq:
            require(resumed == prev and calls == (chunks - resumed) * CHUNK,
                    f"(d) {model}: rounds {seq}")
            prev = chunks
    spent = payload["budget"]["spent"]
    require(spent == out["run calls"]
            and spent <= max(BUDGET_TOTAL, len(SUITE_MODELS) * BUDGET_MIN),
            f"(d): spent {spent}, {out['run calls']} engine calls")
    for name in ("flash_attention", "decode_attention", "bootstrap_partials", "ssd"):
        require(out["run launches"][name] > 0, f"(d): {name} was not launched")
    t = payload["tasks"][task.task_id]
    a, b = SUITE_MODELS
    host = sequential_compare(
        t["metric"], res.result(a, task.task_id).stream_stats,
        res.result(b, task.task_id).stream_stats, alpha=budget.alpha,
        margin=budget.margin, rho=budget.effective_rho(), method=budget.method)
    require(t["verdicts"] == {f"{a} vs {b}": host.verdict}
            and (t["certified"] or t["half_width"] == host.half_width),
            f"(d): payload {t}, host rerun {host}")
    require(t["reason"] in ("certified", "budget_exhausted", "exhausted")
            and (t["certified"] or t["verdicts"][f"{a} vs {b}"] == "undecided"),
            f"(d): {t}")
    # the replay: the same payload from the spill dirs, no engine call
    require(out["replay calls"] == 0 and out["replay"].adaptive == payload,
            f"(d) replay: {out['replay calls']} engine calls, payload "
            f"{out['replay'].adaptive}")
    for name in ("flash_attention", "decode_attention", "bootstrap_partials", "ssd"):
        require(out["replay launches"][name] == 0, f"(d) replay launched {name}")
    log(f"phase 8 (d): {payload['budget']['rounds']} rounds, {spent} of "
        f"{BUDGET_TOTAL} examples, {t['reason']}, verdict {t['verdicts']} equal to "
        f"the host's sequential_compare; the replay made no engine call")
    return out["run launches"]


def streaming_phase(torch, session, models, metrics) -> dict[str, dict[str, int]]:
    """Phase 8, inside phase 6's session (no new weights): (a) spill, crash
    and resume, (b) concurrent chunks, (c) early stopping, (d) the adaptive
    budget over both engines.  Returns the launches of (a)'s resumed run
    and of (d)."""
    import tempfile

    from repro_torch.core import EvalTask, StatisticsConfig

    t0 = time.perf_counter()
    task = EvalTask(
        "phase-8", model=models[0], metrics=metrics,
        statistics=StatisticsConfig(bootstrap_iterations=N_BOOT,
                                    ci_method="percentile", backend="device"),
    ).with_streaming(max_memory_rows=CHUNK)
    with tempfile.TemporaryDirectory() as tmp:
        ref, ref_texts, resumed = resume_phase(torch, session, task, tmp)
        t_a = time.perf_counter()
        concurrent_phase(torch, session, task, ref, ref_texts)
        t_b = time.perf_counter()
        stopping_phase(torch, session, task, tmp, ref)
        t_c = time.perf_counter()
        adaptive = adaptive_phase(torch, session, models, metrics, tmp)
        t_d = time.perf_counter()
    log(f"phase 8 walls: (a) {t_a - t0:.1f} s, (b) {t_b - t_a:.1f} s, "
        f"(c) {t_c - t_b:.1f} s, (d) {t_d - t_c:.1f} s; {t_d - t0:.1f} s in all")
    return {"resumed": resumed, "adaptive": adaptive}


# -- phase 9: the serving fabric ---------------------------------------------------

#: phase 9: replicas of qwen3-4b on the card; (b)'s replica crash (replica
#: 0) and hang (replica 1) at these batcher steps, the hang's length and the
#: health probe's pumps; (c)'s request deadline
FABRIC_REPLICAS = 2
CRASH_STEP, HANG_STEP, HANG_STEPS, PROBE_STEPS = 6, 10, 12, 4
DEADLINE_S = 0.5
FABRIC_KERNELS = ("flash_attention", "decode_attention")


def fabric_run(torch, params, yard, label, task, faults=(), check=True):
    """``run_task`` over ``LOCKSTEP_ROWS`` QA rows in a fresh session whose
    replicas share ``params`` and a copy of phase 7 (a)'s tokenizer, with
    ``faults`` scheduled; every launch count set to 0 just before and read
    just after.  Returns (result, launches, wall, the service's snapshot,
    the schedule, the replicas' engines), the snapshot taken after the
    service closed."""
    from repro_torch.core import EvalSession
    from repro_torch.data import iter_qa_examples
    from repro_torch.ft import ServingFaultSchedule

    plan = ServingFaultSchedule(list(faults))
    kw = {"n_slots": N_SLOTS, "max_len": MAX_LEN, "params": params,
          "tokenizer": tokenizer_copy(yard["tokenizer"])}
    if faults:
        kw["fault_plan"] = plan
    with EvalSession(device="cuda", engine_kwargs=kw) as s:
        svc = s.service_for(task.model, task.inference)
        zero_counts()
        t0 = time.perf_counter()
        result = s.run_task(iter_qa_examples(LOCKSTEP_ROWS, seed=0), task)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        svc.close()
        snap = svc.snapshot()
        engines = [rep.engine for rep in svc.replicas]
        free = [(e.batcher.slots_busy, len(e.batcher.queue)) for e in engines]
    per = [{k: r[k] for k in ("routed", "dispatched", "completed", "restarts",
                              "cancelled", "broken")} for r in snap["replica_stats"]]
    log(f"{label}: run_task wall {wall:.3f} s, {result.engine_stats['calls']} engine "
        f"calls, launches {launches}; service "
        f"{ {k: snap[k] for k in ('dispatched', 'completed', 'errors', 'restarts', 'deadline_expiries', 'hedges_issued', 'hedges_won')} }; "
        f"replicas {per}; busy slots and queue at close {free}; injected {plan.injected}")
    require(snap["replicas"] == FABRIC_REPLICAS, f"{label}: {snap['replicas']} replicas")
    require(free == [(0, 0)] * FABRIC_REPLICAS, f"{label}: slots or queue held at close")
    require(not result.failures, f"{label}: failures {result.failures[:3]}")
    for name in FABRIC_KERNELS + (("bootstrap_partials",) if task.streaming.enabled else ()):
        require(launches[name] > 0, f"{label}: {name} was not launched")
    return result, launches, wall, snap, plan


def fabric_phase(torch, yard) -> dict[str, dict[str, int]]:
    """Phase 9, the serving fabric, in sessions of its own (a service's
    fan-out is fixed by the first task that reaches it): full-width
    qwen3-4b, ``FABRIC_REPLICAS`` replicas on the card sharing one set of
    random bf16 weights (phase 2's seed, made once) and phase 7 (a)'s
    tokenizer memory, over phase 7 (a)'s rows and tasks.  (a) the default
    ``least_loaded`` routing in memory and streaming (``backend="device"``):
    bit for bit phase 7 (a)'s single-engine service runs, both replicas
    dispatched, their dispatches summing to the rows' engine calls; (b)
    streaming with a crash of replica 0 and a hang of replica 1 past the
    health probe: bit for bit (a), no failure, two restarts, both faults
    injected, kernel 1 launched again for the survivors; (c) in memory with
    replica 0 hung for the whole run, no probe and a short deadline: every
    row served by replica 1 with (a)'s texts, a deadline expiry, a hedge and
    a cancelled losing leg, every slot free at close.  Returns the launches
    of each run."""
    from repro_torch.configs import get_config
    from repro_torch.core import InferenceConfig
    from repro_torch.device import resolve_device
    from repro_torch.ft import ServingFault
    from repro_torch.models import init_params

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    mem_task, mem_ref, mem_wall = yard["in memory"]
    stream_task, stream_ref, stream_wall = yard["streaming"]
    cfg = get_config(stream_task.model.model_name)
    params = init_params(cfg.reduced() if stream_task.model.reduced else cfg,
                         stream_task.model.seed, device=resolve_device("cuda"))

    def fleet(task, **inference):
        inf = dataclasses.replace(task.inference, n_replicas=FABRIC_REPLICAS, **inference)
        return dataclasses.replace(task, inference=inf)

    out = {}
    # (a) two replicas, least-loaded routing
    runs = {}
    for label, task, ref, ref_wall in (("in memory", mem_task, mem_ref, mem_wall),
                                       ("streaming", stream_task, stream_ref, stream_wall)):
        res, launches, wall, snap, _ = fabric_run(
            torch, params, yard, f"phase 9 (a) {label}", fleet(task))
        require(same_result(torch, res, ref),
                f"(a) {label}: texts, scores, metrics or streaming state differ from "
                f"phase 7 (a)'s single engine")
        per = [r["dispatched"] for r in snap["replica_stats"]]
        require(min(per) >= 1 and sum(per) == res.engine_stats["calls"] == LOCKSTEP_ROWS,
                f"(a) {label}: dispatched {per}, engine calls {res.engine_stats['calls']}")
        require(snap["restarts"] == snap["errors"] == snap["hedges_issued"] == 0,
                f"(a) {label}: {snap}")
        log(f"phase 9 (a) {label}: bit for bit phase 7 (a)'s single engine; wall "
            f"{wall:.3f} s on {FABRIC_REPLICAS} replicas against {ref_wall:.3f} s on one; "
            f"dispatched {per}")
        runs[label] = (res, launches)
        out[f"(a) {label}"] = launches
    base, base_launches = runs["streaming"]

    # (b) a crash of replica 0 and a hang of replica 1 past the probe
    faults = (ServingFault(0, CRASH_STEP, "replica_crash"),
              ServingFault(1, HANG_STEP, "hang", duration=HANG_STEPS))
    res, launches, wall, snap, plan = fabric_run(
        torch, params, yard, "phase 9 (b) faults, streaming",
        fleet(stream_task, health_probe_steps=PROBE_STEPS), faults)
    require(same_result(torch, res, base), "(b): results differ from (a)'s streaming run")
    require(snap["restarts"] == 2 and snap["errors"] == 0
            and [r["restarts"] for r in snap["replica_stats"]] == [1, 1],
            f"(b): restarts {snap['restarts']}, errors {snap['errors']}")
    require(sorted((r, k) for r, _, k in plan.injected)
            == [(0, "replica_crash"), (1, "hang")], f"(b): injected {plan.injected}")
    # least-loaded routing deals the 16 rows 8 and 8 (no row finishes before
    # its 32nd step), and a replica's 8 rows fill 8 of its 16 slots from its
    # first steps: each row is in a slot at its replica's failure (step 6 or
    # 10), so each is dispatched and prefilled once more
    extra = launches["flash_attention"] - base_launches["flash_attention"]
    again = sum(r["dispatched"] for r in snap["replica_stats"]) - LOCKSTEP_ROWS
    require(again == LOCKSTEP_ROWS and extra == again * QWEN_LAYERS,
            f"(b): {again} rows dispatched again, {launches['flash_attention']} "
            f"prefill launches against (a)'s {base_launches['flash_attention']}; "
            f"want {LOCKSTEP_ROWS} and {LOCKSTEP_ROWS * QWEN_LAYERS} more")
    log(f"phase 9 (b): bit for bit (a); restarts 2 (replica 0 crashed at step "
        f"{CRASH_STEP}, replica 1 hung at step {HANG_STEP} and caught by the probe after "
        f"{PROBE_STEPS} pumps); {again} survivors dispatched and prefilled again "
        f"({extra} more kernel 1 launches); wall {wall:.3f} s")
    out["(b)"] = launches

    # (c) replica 0 hung for the whole run, no probe, a short deadline
    res, launches, wall, snap, plan = fabric_run(
        torch, params, yard, "phase 9 (c) deadline and hedge, in memory",
        fleet(mem_task, request_deadline_s=DEADLINE_S),
        (ServingFault(0, 0, "hang", duration=10**9),))
    per = snap["replica_stats"]
    require(res.responses == runs["in memory"][0].responses, "(c): texts differ from (a)'s")
    require([r["completed"] for r in per] == [0, LOCKSTEP_ROWS],
            f"(c): completed by replica {[r['completed'] for r in per]}")
    require(snap["deadline_expiries"] >= 1 and snap["hedges_issued"] >= 1
            and snap["hedges_won"] >= 1 and per[0]["cancelled"] >= 1,
            f"(c): expiries {snap['deadline_expiries']}, hedges {snap['hedges_issued']} "
            f"(won {snap['hedges_won']}), cancelled on replica 0 {per[0]['cancelled']}")
    require(snap["restarts"] == snap["errors"] == 0 and plan.injected == [(0, 0, "hang")],
            f"(c): restarts {snap['restarts']}, errors {snap['errors']}, "
            f"injected {plan.injected}")
    log(f"phase 9 (c): every row served by replica 1 with (a)'s texts; "
        f"{snap['deadline_expiries']} expiries, {snap['hedges_issued']} hedges "
        f"({snap['hedges_won']} won), {per[0]['cancelled']} losing legs cancelled on the "
        f"hung replica; wall {wall:.3f} s")
    out["(c)"] = launches
    del params
    log(f"phase 9 took {time.perf_counter() - t_phase:.1f} s, "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB peak allocated")
    return out


# -- phase 10: the MoE family -----------------------------------------------------

#: phase 10 (d): one MoE layer over a prompt of phase 3's full length
#: (capacity 40 an expert) against the naive version, within 2^-6 of the
#: value plus 2^-6 of the row's largest (tests/test_torch_moe.py holds the
#: bf16 block to 2/3 of it at narrower widths); the input's seed
MOE_LAYER_TOKENS = 478
MOE_NAIVE_TOL = 2.0**-6
MOE_LAYER_SEED = 10
#: the four attention kernels phase 10 drives
MOE_KERNELS = ("flash_attention", "decode_attention", "paged_decode_attention",
               "quant_paged_decode_attention")


def gib(n_bytes: int) -> str:
    return f"{n_bytes / 2**30:.2f} GiB"


def big_contiguous(torch, params, model_name: str, label: str,
                   n_rows: int = N_ROWS) -> dict[str, int]:
    """Phases 10 (a) and 11 (a): ``run_task`` over phase 2's rows on the
    contiguous f32 cache, then phase 2's engine gates."""
    from repro_torch.core import EvalSession

    task = make_task(model_name=model_name)
    engine_kwargs = {"n_slots": N_SLOTS, "max_len": MAX_LEN, "params": params}
    with EvalSession(device="cuda", engine_kwargs=engine_kwargs) as session:
        engine = session.engine_for(task.model, task.inference)
        launches, *_ = timed_run_task(
            torch, session, task,
            ("flash_attention", "decode_attention", "bootstrap_partials"),
            f"{label} contiguous", n_rows=n_rows)
        engine_gates(torch, engine, task, label)
        log(f"{label} {serving_clean(session, label)}; "
            f"{gib(torch.cuda.max_memory_allocated())} peak allocated")
    free_cuda(torch)
    return launches


def moe_layer_gate(torch, params) -> None:
    """Phase 10 (d): MoE layer 0 of the full-width weights over
    ``MOE_LAYER_TOKENS`` bf16 hidden states sharing one direction (the
    router then favours some experts, as a prompt's states do): the
    fixed-shape block against the naive token-by-token version in f32,
    the routing mask and kept set equal exactly, tokens dropped."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config(MOE)
    p = {k: v[0] for k, v in params["moe_layers"]["moe"].items()}
    cap = moe.expert_capacity(cfg, MOE_LAYER_TOKENS)
    g = torch.Generator(device="cuda").manual_seed(MOE_LAYER_SEED)
    x = (torch.randn((1, MOE_LAYER_TOKENS, cfg.d_model), generator=g, device="cuda")
         + 2.0 * torch.randn((cfg.d_model,), generator=g, device="cuda"))
    x = x.to(torch.bfloat16)
    got = moe.moe_block(p, cfg, x)
    _, _, mask, keep, _ = moe.route(p, cfg, x)
    t0 = time.perf_counter()
    want, nmask, nkeep = moe.moe_block_naive(p, cfg, x)
    torch.cuda.synchronize()
    naive_s = time.perf_counter() - t0
    require(bool(torch.equal(mask, nmask)), "phase 10 (d): routing masks differ")
    require(bool(torch.equal(keep, nkeep)), "phase 10 (d): kept sets differ")
    dropped = int((nmask & ~nkeep).sum())
    require(dropped > 0, "phase 10 (d): no token was dropped")
    err, ratio = rowwise(torch, got, want, MOE_NAIVE_TOL, MOE_NAIVE_TOL)
    require(ratio <= 1.0, f"phase 10 (d): error/allowance {ratio:.3g}")
    log(f"phase 10 (d): MoE layer 0 over {MOE_LAYER_TOKENS} tokens, {cfg.n_experts} "
        f"experts, top {cfg.n_experts_per_token}, capacity {cap}: mask "
        f"({int(nmask.sum())} choices) and kept set equal the naive version's, "
        f"{dropped} choices dropped in {int((nmask & ~nkeep).any(-1).sum())} "
        f"tokens, most tokens an expert {int(nmask.sum(1).max())}; err {err:.3g} "
        f"(ratio {ratio:.3g}); the naive version took {naive_s:.1f} s")


def moe_phase(torch, fs) -> dict[str, dict[str, int]]:
    """Phase 10, the MoE family, after every earlier session has closed:
    full-width qwen3-moe-30b-a3b with random bf16 weights (seed 0), made
    once and shared by every engine of the phase, one cache alive at a
    time.  (a) contiguous, (b) paged f32 with prefix sharing and the
    ``infer_batch`` gates, (c) the int8 pool, (d) one layer against the
    naive version.  Returns the launches of (a)-(c)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    log(f"phase 10: {gib(torch.cuda.memory_allocated())} allocated before the weights")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(get_config(MOE), 0, device="cuda")
    torch.cuda.synchronize()
    log(f"phase 10 weights on the card in {time.perf_counter() - t0:.3f} s: "
        f"{gib(torch.cuda.memory_allocated())} allocated, "
        f"{gib(torch.cuda.max_memory_allocated())} peak while made")
    t_a = time.perf_counter()
    out = {"contiguous": big_contiguous(torch, params, MOE, "phase 10 (a)",
                                        BIG_ROWS)}
    t_b = time.perf_counter()
    out["f32"], *_ = paged_run(torch, params, fs, "phase 10 (b) paged f32",
                               "paged_decode_attention", MOE, BIG_ROWS,
                               prefix_cache=True)
    # room for 8 prompts and the page of growth the admission gate keeps for
    # each busy slot: all 8 grow past it, in a quarter of phase 3's steps at
    # this model's slower step (one page fewer admits 7, which never preempt)
    infer_gates(torch, params, fs, MOE, pool=8 * (-(-fs.prompt_len // PAGE_SIZE) + 1))
    t_c = time.perf_counter()
    out["int8"], _, _, texts = paged_run(torch, params, fs, "phase 10 (c) paged int8",
                                         "quant_paged_decode_attention", MOE,
                                         BIG_ROWS, kv_cache_dtype="int8")
    require(len(texts) == BIG_ROWS and all(texts.values()),
            "phase 10 (c): an empty text")
    t_d = time.perf_counter()
    moe_layer_gate(torch, params)
    log(f"phase 10 walls: (a) {t_b - t_a:.1f} s, (b) {t_c - t_b:.1f} s, "
        f"(c) {t_d - t_c:.1f} s, (d) {time.perf_counter() - t_d:.1f} s; "
        f"{gib(torch.cuda.max_memory_allocated())} peak allocated")
    return out


# -- phase 11: the qkv-bias dense family -------------------------------------------

#: phase 11: the seeded random q/k/v biases put in place of the zeros the
#: reference initialises (a zero bias would hide a dropped add): their std
#: (about half the spread of a projected value) and seed
BIAS_STD, BIAS_SEED = 0.5, 11


def bias_gate(torch, params) -> None:
    """One 12-token prefill of phase 11's model with its biases and with
    ``bq`` zeroed: the logits must differ, or the biases are not added."""
    from repro_torch.configs import get_config
    from repro_torch.models import TransformerLM

    model = TransformerLM(get_config(QWEN25))
    cache = model.init_cache(1, PROMPT_LEN, "cuda")
    toks = torch.arange(2, 2 + PROMPT_LEN, device="cuda")[None, :]
    attn = params["layers"]["attn"]
    with_bias = model.prefill(params, toks, cache, 0)
    kept = attn["bq"].clone()
    attn["bq"].zero_()
    without = model.prefill(params, toks, cache, 0)
    attn["bq"].copy_(kept)
    diff = float((with_bias - without).abs().max())
    require(diff > 0.0, "phase 11: zeroing bq left the logits unchanged")
    log(f"phase 11 bias gate: zeroing bq moves a 12-token prefill's logits by "
        f"up to {diff:.4g} (max |logit| {float(with_bias.abs().max()):.4g})")
    del cache


def qwen25_phase(torch, fs) -> dict[str, dict[str, int]]:
    """Phase 11, the qkv-bias dense family, after phase 10 has freed its
    weights: full-width qwen2.5-32b with random bf16 weights (seed 0; the
    MLP leaves drawn a layer at a time) and seeded random q/k/v biases,
    made once and shared by every engine of the phase, one cache alive at a
    time.  (a) contiguous ``run_task`` and phase 2's engine gates, (b) paged
    f32 with prefix sharing and the ``infer_batch`` gates, (c) the int8
    pool, each over ``BIG_ROWS`` rows.  Returns the launches of (a)-(c)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    log(f"phase 11: {gib(torch.cuda.memory_allocated())} allocated before the weights")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(get_config(QWEN25), 0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(BIAS_SEED)
    attn = params["layers"]["attn"]
    for name in ("bq", "bk", "bv"):
        attn[name].copy_(BIAS_STD * torch.randn(attn[name].shape, generator=g,
                                                device="cuda"))
    torch.cuda.synchronize()
    log(f"phase 11 weights on the card in {time.perf_counter() - t0:.3f} s: "
        f"{gib(torch.cuda.memory_allocated())} allocated, "
        f"{gib(torch.cuda.max_memory_allocated())} peak while made")
    bias_gate(torch, params)
    t_a = time.perf_counter()
    out = {"contiguous": big_contiguous(torch, params, QWEN25, "phase 11 (a)",
                                        BIG_ROWS)}
    t_b = time.perf_counter()
    out["f32"], *_ = paged_run(torch, params, fs, "phase 11 (b) paged f32",
                               "paged_decode_attention", QWEN25, BIG_ROWS,
                               prefix_cache=True)
    # phase 10's preemption pool: 8 prompts and a page of growth each
    infer_gates(torch, params, fs, QWEN25,
                pool=8 * (-(-fs.prompt_len // PAGE_SIZE) + 1))
    t_c = time.perf_counter()
    out["int8"], _, _, texts = paged_run(torch, params, fs, "phase 11 (c) paged int8",
                                         "quant_paged_decode_attention", QWEN25,
                                         BIG_ROWS, kv_cache_dtype="int8")
    require(len(texts) == BIG_ROWS and all(texts.values()),
            "phase 11 (c): an empty text")
    log(f"phase 11 walls: (a) {t_b - t_a:.1f} s, (b) {t_c - t_b:.1f} s, "
        f"(c) {time.perf_counter() - t_c:.1f} s; "
        f"{gib(torch.cuda.max_memory_allocated())} peak allocated")
    return out


# -- phase 12: the hybrid family -----------------------------------------------------

#: phase 12's layer gates: one shared-block application and one Mamba2 layer
#: of the full-width weights over a prompt of phase 3's full length, with
#: the kernels against the same code with their plain versions, both bf16:
#: 2^-6 of the value plus 2^-6 of the row's largest (the kernels' own gates
#: allow 2^-7 before a projection sums thousands of their outputs); the
#: input's seed
HYBRID_LAYER_TOL = 2.0**-6
HYBRID_LAYER_SEED = 12


def hybrid_layer_gate(torch, params, n_tok: int) -> None:
    """Phase 12 (d): application 0 of the shared block and Mamba2 layer 0
    over ``n_tok`` bf16 hidden states sharing one direction, through the
    prefill and SSD kernels against the same layers through the kernels'
    plain versions (``flash_attention_ref``, ``ssd_chunked``) on the card;
    the Mamba2 layer's final state too."""
    import repro_torch.models.attention as attn_mod
    import repro_torch.models.ssm as ssm_mod
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.models import HybridLM, layers

    cfg = get_config(ZAMBA)
    model = HybridLM(cfg)
    g = torch.Generator(device="cuda").manual_seed(HYBRID_LAYER_SEED)
    x = (torch.randn((1, n_tok, cfg.d_model), generator=g, device="cuda")
         + 2.0 * torch.randn((cfg.d_model,), generator=g, device="cuda"))
    x = x.to(torch.bfloat16)
    rope = layers.rope_cos_sin(torch.arange(n_tok, device="cuda")[None, :],
                               cfg.head_dim, cfg.rope_theta)
    kv = torch.zeros((2, 1, n_tok, cfg.n_kv_heads, cfg.head_dim), device="cuda")
    mixer = {k: v[0, 0] for k, v in params["groups"]["mixer"].items()}
    ln = params["groups"]["ln"][0, 0]
    conv = torch.zeros((cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state),
                       device="cuda")
    state = torch.zeros((cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state),
                        device="cuda")

    def run():
        block = model.shared_block(params, 0, x, lambda pa, h: attn_mod.gqa_prefill(
            pa, cfg, h, kv[0], kv[1], 0, rope))
        y = ssm_mod.mamba2_prefill(mixer, cfg, layers.rms_norm(ln, x, cfg.norm_eps),
                                   conv, state)
        return block, y, state.clone()

    got = run()
    flash, scan = attn_mod.flash_attention_bshd, ssm_mod.ssd_apply
    attn_mod.flash_attention_bshd = flash_attention_ref
    ssm_mod.ssd_apply = lambda *a, chunk: ssm_mod.ssd_chunked(*a, chunk)
    try:
        want = run()
    finally:
        attn_mod.flash_attention_bshd, ssm_mod.ssd_apply = flash, scan
    torch.cuda.synchronize()
    ratios = []
    for name, a, b in zip(("shared block", "Mamba2 layer", "Mamba2 state"), got, want):
        err, ratio = rowwise(torch, a, b, HYBRID_LAYER_TOL, HYBRID_LAYER_TOL)
        require(ratio <= 1.0, f"phase 12 (d) {name}: error/allowance {ratio:.3g}")
        ratios.append(f"{name} err {err:.3g} (ratio {ratio:.3g})")
    log(f"phase 12 (d): application 0 of the shared block and Mamba2 layer 0 over "
        f"{n_tok} tokens, kernels against plain versions: " + "; ".join(ratios))


def zamba_phase(torch, fs) -> dict[str, int]:
    """Phase 12, the hybrid family, after phase 11 has freed its weights:
    full-width zamba2-7b (81 Mamba2 layers, the shared block after every
    6th: 13 applications and a tail of 3) with random bf16 weights (seed 0).
    (a) ``run_task`` over ``BIG_ROWS`` of phase 3's few-shot prompts on the
    contiguous cache: kernel 1 launched 13 times a prompt, kernel 8 81
    times, kernel 2 13 times a decode step, exactly; (b) phase 4's gates:
    batch invariance, a reused slot, the prefill-to-decode hand-off; (c) a
    paged cache refused; (d) one shared-block application and one Mamba2
    layer against their plain versions.  Returns (a)'s launches."""
    from repro_torch.configs import get_config
    from repro_torch.core import EvalSession, InferenceRequest, TorchLocalEngine
    from repro_torch.data import iter_qa_examples, render
    from repro_torch.models import init_params

    cfg = get_config(ZAMBA)
    apps = cfg.n_layers // cfg.shared_attn_every
    log(f"phase 12: {gib(torch.cuda.memory_allocated())} allocated before the weights")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    log(f"phase 12 weights on the card in {time.perf_counter() - t0:.3f} s: "
        f"{gib(torch.cuda.memory_allocated())} allocated, "
        f"{gib(torch.cuda.max_memory_allocated())} peak while made")
    task = make_task(fs.template, model_name=ZAMBA)
    engine_kwargs = {"n_slots": N_SLOTS, "max_len": MAX_LEN, "params": params}
    t_a = time.perf_counter()
    with EvalSession(device="cuda", engine_kwargs=engine_kwargs) as session:
        engine = session.engine_for(task.model, task.inference)
        with Probe() as probe:
            launches, st, *_ = timed_run_task(
                torch, session, task,
                ("flash_attention", "decode_attention", "ssd", "bootstrap_partials"),
                "phase 12 (a) hybrid path", n_rows=BIG_ROWS)
        want = {"flash_attention": apps * st["admissions"],
                "ssd": cfg.n_layers * st["admissions"],
                "decode_attention": apps * st["steps"]}
        got = {k: launches[k] for k in want}
        require(st["admissions"] == BIG_ROWS and got == want,
                f"phase 12 (a): {st['admissions']} prefills, {st['steps']} decode "
                f"steps, launches {got}, not {want}")
        require(int(probe.bad) == 0, "phase 12 (a): logits hold NaN or inf")
        b = engine.batcher
        slot = [b.cache.kv.k[:, 0], b.cache.kv.v[:, 0], b.cache.ssm.conv[:, 0],
                b.cache.ssm.state[:, 0]]
        log(f"phase 12 (a): launches {got} = {apps} and {cfg.n_layers} a prefill "
            f"x {st['admissions']}, {apps} a decode step x {st['steps']}; state "
            f"bytes per slot {sum(t.numel() for t in slot) * 4} (KV rows "
            f"{(slot[0].numel() + slot[1].numel()) * 4}); "
            f"{gib(torch.cuda.max_memory_allocated())} peak allocated")

        t_b = time.perf_counter()
        rows = list(iter_qa_examples(N_SLOTS, seed=0))
        reqs = [InferenceRequest(render(fs.template, r), MAX_TOKENS) for r in rows]
        full = engine.infer_batch(reqs)
        alone = engine.infer_batch(reqs[:1])
        require(full[0].text == alone[0].text
                and full[0].output_tokens == alone[0].output_tokens,
                f"phase 12: batch-dependent tokens: {full[0].text!r} vs "
                f"{alone[0].text!r}")
        log(f"phase 12 batch invariance: prompt 0 gives {alone[0].output_tokens} "
            f"identical tokens alone and among {N_SLOTS} slots")
        short = InferenceRequest("", MAX_TOKENS)
        (reused,) = engine.infer_batch([short])
        fresh_engine = TorchLocalEngine(task.model, n_slots=N_SLOTS, max_len=MAX_LEN,
                                        device="cuda", params=params)
        fresh_engine.initialize()
        fresh_engine._tokenizer = engine._tokenizer
        (fresh,) = fresh_engine.infer_batch([short])
        require(reused.input_tokens == 1 and reused.text == fresh.text
                and reused.output_tokens == fresh.output_tokens,
                f"phase 12 reused slot: {reused.text!r} vs fresh engine {fresh.text!r}")
        fresh_engine.shutdown()
        del fresh_engine
        free_cuda(torch)
        log(f"phase 12 slot reuse: a 1-token prompt in a slot that held a "
            f"{fs.prompt_len}-token prompt gives the fresh engine's "
            f"{fresh.output_tokens} tokens")
        prompt = engine._tokenizer.encode(render(fs.template, rows[0]))
        for length in (len(prompt), 2):
            handoff_gate(torch, b, prompt, length)
        toks = torch.tensor([prompt], device="cuda")
        step_breakdown(torch, f"phase 12 prefill ({len(prompt)} tokens into slot 0)",
                       lambda: b.model.prefill(b.params, toks, b.cache, 0),
                       kernel="flash")
        nxt = torch.full((N_SLOTS, 1), 7, dtype=torch.int64, device="cuda")
        pos = torch.full((N_SLOTS,), len(prompt), dtype=torch.int64, device="cuda")
        step_breakdown(torch, f"phase 12 decode step (batch {N_SLOTS}, positions "
                       f"{len(prompt)})",
                       lambda: b.model.decode_step(b.params, nxt, b.cache, pos),
                       kernel=DEVICE_KERNEL["decode_attention"])
        log(f"phase 12 {serving_clean(session, 'phase 12')}")
    free_cuda(torch)

    t_c = time.perf_counter()
    paged = TorchLocalEngine(task.model, n_slots=N_SLOTS, max_len=MAX_LEN,
                             device="cuda", params=params, kv_page_size=PAGE_SIZE)
    try:
        paged.initialize()
    except ValueError as e:
        require("not hybrid" in str(e), f"phase 12 (c): another error: {e}")
        log(f"phase 12 (c): a paged engine raises the reference's error: {e}")
    else:
        raise CheckFailed("phase 12 (c): a paged hybrid engine was built")
    t_d = time.perf_counter()
    hybrid_layer_gate(torch, params, fs.prompt_len)
    log(f"phase 12 walls: (a) {t_b - t_a:.1f} s, (b) {t_c - t_b:.1f} s, "
        f"(c) {t_d - t_c:.1f} s, (d) {time.perf_counter() - t_d:.1f} s; "
        f"{gib(torch.cuda.max_memory_allocated())} peak allocated")
    return launches


# -- phase 13: the MLA family ------------------------------------------------------

#: phase 13 (d): one MLA layer of the full-width weights through the prefill
#: kernel against the same layer through its plain version, both bf16:
#: phase 12's layer tolerance; the input's seed
MLA_LAYER_TOL = 2.0**-6
MLA_LAYER_SEED = 13
#: phase 13 (d): tokens decoded after a prefill, each step's logits held to a
#: full prefill of the same tokens.  The prefill attends through the
#: decompressed K/V in bf16 (the kernel's P rounded to bf16), the decode in
#: the latent space in f32, so the two round at other points through 62
#: layers: phase 4's hand-off allowance, 15% of the largest logit, with the
#: same control (a zeroed slot must move the logits 3x as far)
MLA_DECODE_STEPS = 4


def mla_layer_gate(torch, params, n_tok: int) -> None:
    """Phase 13 (d), the layer: layer 0's MLA attention over ``n_tok``
    bf16 hidden states sharing one direction, through kernel 1 at (96, 64)
    against the same function through ``flash_attention_ref`` on the card;
    the compressed rows it writes are the same either way."""
    import repro_torch.models.attention as attn_mod
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.models import layers

    cfg = get_config(MINICPM)
    p = {k: v[0] for k, v in params["layers"]["attn"].items()}
    g = torch.Generator(device="cuda").manual_seed(MLA_LAYER_SEED)
    x = (torch.randn((1, n_tok, cfg.d_model), generator=g, device="cuda")
         + 2.0 * torch.randn((cfg.d_model,), generator=g, device="cuda"))
    x = x.to(torch.bfloat16)
    rope = layers.rope_cos_sin(torch.arange(n_tok, device="cuda")[None, :],
                               cfg.qk_rope_head_dim, cfg.rope_theta)
    caches = [(torch.zeros((1, n_tok, cfg.kv_lora_rank), device="cuda"),
               torch.zeros((1, n_tok, cfg.qk_rope_head_dim), device="cuda"))
              for _ in range(2)]
    got = attn_mod.mla_prefill(p, cfg, x, *caches[0], 0, rope)
    flash = attn_mod.flash_attention_bshd
    attn_mod.flash_attention_bshd = flash_attention_ref
    try:
        want = attn_mod.mla_prefill(p, cfg, x, *caches[1], 0, rope)
    finally:
        attn_mod.flash_attention_bshd = flash
    torch.cuda.synchronize()
    err, ratio = rowwise(torch, got, want, MLA_LAYER_TOL, MLA_LAYER_TOL)
    require(ratio <= 1.0, f"phase 13 (d) MLA layer: error/allowance {ratio:.3g}")
    require(all(bool(torch.equal(a, b)) for a, b in zip(*caches)),
            "phase 13 (d): the compressed rows depend on the attention path")
    log(f"phase 13 (d): MLA layer 0 over {n_tok} tokens, kernel 1 at (96, 64) "
        f"against its plain version: err {err:.3g} (ratio {ratio:.3g}); the "
        f"compressed rows equal")


def mla_consistency_gate(torch, b, prompt: list[int]) -> None:
    """Phase 13 (d), the decode: slot 0 prefilled with ``prompt``, then
    ``MLA_DECODE_STEPS`` decode steps of every slot feeding the next
    tokens; each step's logits of slot 0 against a full prefill of the
    prompt and the tokens so far (into slot 1), and against the same step
    from a zeroed slot 0 (the control)."""
    n = len(prompt)
    seq = prompt + [int(t) for t in torch.randint(
        4, b.cfg.vocab_size, (MLA_DECODE_STEPS,),
        generator=torch.Generator().manual_seed(MLA_LAYER_SEED))]
    b.model.prefill(b.params, torch.tensor([prompt], device="cuda"), b.cache, 0)
    worst, worst_cold, argmax_equal = 0.0, float("inf"), 0
    for i in range(MLA_DECODE_STEPS):
        toks = torch.zeros((N_SLOTS, 1), dtype=torch.int64, device="cuda")
        toks[0, 0] = seq[n + i]
        pos = torch.full((N_SLOTS,), n + i, device="cuda")
        step = b.model.decode_step(b.params, toks, b.cache, pos)[:1]
        full = b.model.prefill(b.params, torch.tensor([seq[: n + i + 1]], device="cuda"),
                               b.cache, 1)
        require(bool(torch.isfinite(step).all() and torch.isfinite(full).all()),
                "phase 13 (d): decode-consistency logits hold NaN or inf")
        scale = float(full.abs().max())
        diff = float((step - full).abs().max())
        worst = max(worst, diff / scale)
        argmax_equal += int(step.argmax()) == int(full.argmax())
        require(diff <= HANDOFF_TOL * scale,
                f"phase 13 (d): decode step {i} {diff:.4g} > {HANDOFF_TOL} x {scale:.4g}")
        if i == MLA_DECODE_STEPS - 1:
            # the control: the same step from a zeroed slot 0
            b.cache.c_kv[:, 0].zero_()
            b.cache.k_rope[:, 0].zero_()
            cold = b.model.decode_step(b.params, toks, b.cache, pos)[:1]
            cold_diff = float((cold - full).abs().max())
            worst_cold = cold_diff / scale
            require(cold_diff >= HANDOFF_CONTROL * diff,
                    f"phase 13 (d): a zeroed slot moves the logits by "
                    f"{cold_diff:.4g}, under {HANDOFF_CONTROL} x {diff:.4g}")
    log(f"phase 13 (d): {MLA_DECODE_STEPS} decode steps after a {n}-token prefill "
        f"against full prefills: worst max |decode - prefill| {worst:.4f} of max "
        f"|logit| (gate {HANDOFF_TOL}); argmax equal in {argmax_equal} of "
        f"{MLA_DECODE_STEPS}; from a zeroed slot {worst_cold:.4f}")


def minicpm_phase(torch, fs) -> dict[str, int]:
    """Phase 13, the MLA family, after phase 12 has freed its weights:
    full-width minicpm3-4b (62 layers, 40 heads, query rank 768, KV latent
    256 + a rope key of 32, tied vocab 73,448) with random bf16 weights
    (seed 0), one engine alive at a time.  (a) ``run_task`` over
    ``HALF_ROWS`` of phase 2's QA rows on the contiguous (compressed) cache:
    kernel 1 launched 62 times a prompt, kernel 2 never (the absorbed
    decode runs in plain f32 products), kernel 6; then phase 2's engine
    gates; (b) ``run_task`` over ``BIG_ROWS`` of phase 3's few-shot prompts
    (kernel 1 at 478 tokens, two warpgroups), then a reused slot against a
    fresh engine; (c) a paged engine refused with the reference's error;
    (d) one MLA layer through kernel 1 against its plain version, and
    decode against full prefills.  Returns (a)'s and (b)'s launches."""
    from repro_torch.configs import get_config
    from repro_torch.core import EvalSession, InferenceRequest, TorchLocalEngine
    from repro_torch.data import iter_qa_examples, render
    from repro_torch.models import init_params

    cfg = get_config(MINICPM)
    log(f"phase 13: {gib(torch.cuda.memory_allocated())} allocated before the weights")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"phase 13 weights on the card in {time.perf_counter() - t0:.3f} s: "
        f"{n_params / 1e9:.3f} B parameters, "
        f"{gib(torch.cuda.memory_allocated())} allocated, "
        f"{gib(torch.cuda.max_memory_allocated())} peak while made")
    engine_kwargs = {"n_slots": N_SLOTS, "max_len": MAX_LEN, "params": params}
    launches: dict[str, int] = {}
    walls = []
    with EvalSession(device="cuda", engine_kwargs=engine_kwargs) as session:
        for label, template, n_rows in (("(a) QA prompts", None, HALF_ROWS),
                                        ("(b) few-shot prompts", fs.template,
                                         BIG_ROWS)):
            t_run = time.perf_counter()
            task = make_task(template, model_name=MINICPM)
            engine = session.engine_for(task.model, task.inference)
            with Probe() as probe:
                got, st, *_ = timed_run_task(
                    torch, session, task, ("flash_attention", "bootstrap_partials"),
                    f"phase 13 {label}", n_rows=n_rows)
            run = engine.serving_stats()
            require(int(probe.bad) == 0, f"phase 13 {label}: logits hold NaN or inf")
            prefills = len(probe.prefill_logits)
            require(got["flash_attention"] == cfg.n_layers * prefills
                    and prefills == n_rows and got["decode_attention"] == 0,
                    f"phase 13 {label}: {prefills} prefills, launches {got}: kernel "
                    f"1 not {cfg.n_layers} a prompt, or kernel 2 launched")
            log(f"phase 13 {label}: kernel 1 launched {got['flash_attention']} = "
                f"{cfg.n_layers} x {prefills} prefills, kernel 2 "
                f"{got['decode_attention']}; {run['admissions']} admissions so far")
            for name, n in got.items():
                launches[name] = launches.get(name, 0) + n
            if template is None:
                engine_gates(torch, engine, task, "phase 13 (a)")
            walls.append(time.perf_counter() - t_run)
        # (b)'s slot reuse: a 1-token prompt in a slot that held a few-shot
        # prompt against a fresh engine
        t_reuse = time.perf_counter()
        short = InferenceRequest("", MAX_TOKENS)
        (reused,) = engine.infer_batch([short])
        fresh_engine = TorchLocalEngine(task.model, n_slots=N_SLOTS, max_len=MAX_LEN,
                                        device="cuda", params=params)
        fresh_engine.initialize()
        fresh_engine._tokenizer = engine._tokenizer
        (fresh,) = fresh_engine.infer_batch([short])
        require(reused.input_tokens == 1 and reused.text == fresh.text
                and reused.output_tokens == fresh.output_tokens,
                f"phase 13 reused slot: {reused.text!r} vs fresh engine {fresh.text!r}")
        fresh_engine.shutdown()
        del fresh_engine
        free_cuda(torch)
        log(f"phase 13 slot reuse: a 1-token prompt in a slot that held a "
            f"{fs.prompt_len}-token prompt gives the fresh engine's "
            f"{fresh.output_tokens} tokens")
        walls[-1] += time.perf_counter() - t_reuse
        b = engine.batcher
        slot = b.cache.c_kv[:, 0].numel() + b.cache.k_rope[:, 0].numel()
        log(f"phase 13 cache: {slot * 4 / MAX_LEN:.0f} bytes a token, "
            f"{gib(4 * (b.cache.c_kv.numel() + b.cache.k_rope.numel()))} for "
            f"{N_SLOTS} slots x {MAX_LEN} rows; {serving_clean(session, 'phase 13')}")
        t_d = time.perf_counter()
        rows = list(iter_qa_examples(1, seed=0))
        prompt = engine._tokenizer.encode(render(fs.template, rows[0]))
        mla_consistency_gate(torch, b, prompt)
        del b, engine
    free_cuda(torch)

    t_c = time.perf_counter()
    paged = TorchLocalEngine(task.model, n_slots=N_SLOTS, max_len=MAX_LEN,
                             device="cuda", params=params, kv_page_size=PAGE_SIZE)
    try:
        paged.initialize()
    except ValueError as e:
        require(str(e) == "paged KV cache supports GQA attention families "
                "('dense', 'moe'), not dense with MLA",
                f"phase 13 (c): another error: {e}")
        log(f"phase 13 (c): a paged engine raises the reference's error: {e}")
    else:
        raise CheckFailed("phase 13 (c): a paged MLA engine was built")
    t_l = time.perf_counter()
    mla_layer_gate(torch, params, fs.prompt_len)
    log(f"phase 13 walls: (a) {walls[0]:.1f} s, (b) {walls[1]:.1f} s, (c) "
        f"{t_l - t_c:.1f} s, (d) {t_c - t_d + time.perf_counter() - t_l:.1f} s; "
        f"{gib(torch.cuda.max_memory_allocated())} peak allocated")
    return launches


# -- phase 14: the enc-dec family ---------------------------------------------------

#: phase 14: the seed of the requests' frames (each (1,500, 1,280) f32 at
#: 0.02 scale, as the reference's tests draw them) and of the layer gates'
#: inputs; kernel 1's launches a prompt (every encoder layer's
#: self-attention, every decoder layer's self- and cross-attention) and
#: kernel 2's a decode step (the decoder's self and cross decode)
WHISPER_SEED = 14
#: phase 14 (a)'s requests: half a chunk, to keep the script within its time
#: limit on a slow host
WHISPER_ROWS = CHUNK // 2
WHISPER_PREFILL_LAUNCHES = 96
WHISPER_STEP_LAUNCHES = 64


def whisper_frames(n: int, d_model: int, seed: int = WHISPER_SEED) -> list:
    """``n`` requests' frames, (1,500, d_model) f32 each, from ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [(0.02 * rng.standard_normal((WHISPER_FRAMES, d_model))).astype(np.float32)
            for _ in range(n)]


def whisper_batcher(cfg, params, eos_id: int):
    """Phase 14's batcher: ``N_SLOTS`` slots of ``MAX_LEN`` self rows."""
    from repro_torch.models import EncDecLM
    from repro_torch.serve import ContinuousBatcher

    return ContinuousBatcher(EncDecLM(cfg), cfg, params, n_slots=N_SLOTS,
                             max_len=MAX_LEN, eos_id=eos_id)


def batcher_serve(torch, b, reqs, label: str, prefill_launches: int = WHISPER_PREFILL_LAUNCHES,
                  step_launches: int = WHISPER_STEP_LAUNCHES) -> tuple[dict, dict[str, int]]:
    """Submit ``reqs`` to batcher ``b`` and run them to completion with
    every launch count set to 0 just before and read just after: each
    request completes ("length" or "eos"), kernel 1 launches exactly
    ``prefill_launches`` a prefill and kernel 2 ``step_launches`` a decode
    step (phase 14's counts by default), no other attention kernel
    launches, no logit is NaN or inf.  Logs the launches and the prefill
    and decode-step ms; returns each request's tokens and the launches."""
    before = dict(b.stats.as_dict())
    for fn in counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    with Probe() as probe:
        for r in reqs:
            b.submit(r)
        done = b.run_to_completion()
        b.completions = []
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters().items()}
    st = b.stats.as_dict()
    run = {k: st[k] - before[k] for k in ("admissions", "steps", "prefill_s",
                                           "decode_s", "tokens_generated")}
    want = {"flash_attention": prefill_launches * run["admissions"],
            "decode_attention": step_launches * run["steps"],
            "paged_decode_attention": 0, "quant_paged_decode_attention": 0, "ssd": 0}
    got = {k: launches[k] for k in want}
    require(len(done) == len(reqs) and run["admissions"] == len(reqs)
            and all(c.finished_reason in ("length", "eos") for c in done),
            f"{label}: {len(done)} of {len(reqs)} completed, reasons "
            f"{sorted({c.finished_reason for c in done})}")
    require(got == want, f"{label}: {run['admissions']} prefills, {run['steps']} decode "
            f"steps, launches {got}, not {want}")
    require(int(probe.bad) == 0, f"{label}: logits hold NaN or inf")
    log(f"{label}: {len(done)} requests in {wall:.3f} s; launches {launches} = "
        f"{prefill_launches} x {run['admissions']} prefills and "
        f"{step_launches} x {run['steps']} decode steps; "
        f"{run['prefill_s'] * 1e3 / run['admissions']:.2f} ms a prefill, "
        f"{run['decode_s'] * 1e3 / max(run['steps'], 1):.2f} ms a decode step "
        f"(batch {N_SLOTS}), {run['tokens_generated']} decoded tokens")
    return {c.request_id: c.tokens for c in done}, launches


def whisper_layer_gate(torch, params, enc_frames, prompt: list[int]) -> None:
    """Phase 14 (b), the layers: encoder layer 0 over the 1,500 frames
    (kernel 1 not causal), decoder layer 0's prefill over ``prompt`` (kernel
    1 causal, then not causal over the encoder's output) and one decode
    step of it over 16 slots (kernel 2 over the self and the cross rows),
    each through the kernels against the same code through their plain
    versions on the card, both bf16.  The decoder layer attends over the
    kernels' encoder output on both paths, so the self and cross rows it
    writes are the same either way, and are gated so."""
    import repro_torch.models.attention as attn_mod
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention_ref
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.models import layers
    from repro_torch.models.model import _block

    cfg = get_config(WHISPER)
    enc = _block(params["encoder"], 0)
    dec = _block(params["decoder"], 0)
    x = (torch.from_numpy(enc_frames).cuda()[None].to(torch.bfloat16)
         + params["enc_pos"].to(torch.bfloat16))
    n = len(prompt)
    toks = torch.tensor([prompt], device="cuda")
    y = layers.embed(params["embed"], toks, torch.bfloat16) + params["dec_pos"][:n]
    g = torch.Generator(device="cuda").manual_seed(WHISPER_SEED)
    step_x = torch.randn((N_SLOTS, 1, cfg.d_model), generator=g, device="cuda").to(
        torch.bfloat16)
    pos = torch.arange(n, n + N_SLOTS, device="cuda")
    lengths = (pos + 1).to(torch.int32)
    cross_len = torch.full_like(lengths, WHISPER_FRAMES)

    def encoder_layer():
        h = layers.layer_norm(enc["ln1"], x, cfg.norm_eps)
        e = x + attn_mod.gqa_full_noncausal(enc["attn"], cfg, h)
        return e + layers.mlp(enc["mlp"], layers.layer_norm(enc["ln2"], e, cfg.norm_eps),
                              cfg.act)

    enc_out = encoder_layer()

    def run():
        kv = torch.zeros((4, N_SLOTS, MAX_LEN, cfg.n_kv_heads, cfg.head_dim),
                         device="cuda")
        cross = torch.zeros((2, N_SLOTS, WHISPER_FRAMES, cfg.n_kv_heads, cfg.head_dim),
                            device="cuda")
        e = encoder_layer()
        h = layers.layer_norm(dec["ln1"], y, cfg.norm_eps)
        d = y + attn_mod.gqa_prefill(dec["attn"], cfg, h, kv[0], kv[1], 0, None)
        h = layers.layer_norm(dec["ln_cross"], d, cfg.norm_eps)
        d = d + attn_mod.cross_prefill(dec["cross"], cfg, h, enc_out, cross[0], cross[1],
                                       0)
        # the decode step: every slot's self rows and cross rows random
        kv[2:].normal_(generator=g)
        cross[:, 1:].copy_(cross[:, :1].expand(-1, N_SLOTS - 1, -1, -1, -1))
        h = layers.layer_norm(dec["ln1"], step_x, cfg.norm_eps)
        s_out = attn_mod.gqa_decode(dec["attn"], cfg, h, kv[2], kv[3], pos, lengths, None)
        c_out = attn_mod.cross_decode(dec["cross"], cfg, h, cross[0], cross[1], cross_len)
        return e, d, s_out, c_out, kv, cross

    g.manual_seed(WHISPER_SEED + 1)
    got = run()
    flash, dec_fn = attn_mod.flash_attention_bshd, attn_mod.decode_attention_bshd
    attn_mod.flash_attention_bshd = flash_attention_ref
    attn_mod.decode_attention_bshd = decode_attention_ref
    try:
        g.manual_seed(WHISPER_SEED + 1)
        want = run()
    finally:
        attn_mod.flash_attention_bshd, attn_mod.decode_attention_bshd = flash, dec_fn
    torch.cuda.synchronize()
    ratios = []
    for name, a, b in zip(("encoder layer", "decoder layer prefill", "self decode",
                           "cross decode"), got, want):
        err, ratio = rowwise(torch, a, b, HYBRID_LAYER_TOL, HYBRID_LAYER_TOL)
        require(ratio <= 1.0, f"phase 14 (b) {name}: error/allowance {ratio:.3g}")
        ratios.append(f"{name} err {err:.3g} (ratio {ratio:.3g})")
    require(bool(torch.equal(got[4], want[4]) and torch.equal(got[5], want[5])),
            "phase 14 (b): the cache rows depend on the attention path")
    log(f"phase 14 (b): layer 0 of the encoder over {WHISPER_FRAMES} frames and of "
        f"the decoder over {n} tokens and one {N_SLOTS}-slot decode step, kernels 1 and 2 "
        f"at d = 64 against their plain versions: " + "; ".join(ratios))


def whisper_consistency_gate(torch, b, prompt: list[int], frames) -> None:
    """Phase 14 (b), the decode: slot 0 prefilled with ``prompt`` and
    ``frames``, then ``MLA_DECODE_STEPS`` decode steps of every slot
    feeding the next tokens; each step's logits of slot 0 against a full
    prefill of the prompt and the tokens so far (into slot 1, the same
    frames), and against the same step from a zeroed slot 0 (the
    control)."""
    n = len(prompt)
    fr = torch.from_numpy(frames).cuda()[None]
    seq = prompt + [int(t) for t in torch.randint(
        4, b.cfg.vocab_size, (MLA_DECODE_STEPS,),
        generator=torch.Generator().manual_seed(WHISPER_SEED))]
    b.model.prefill(b.params, torch.tensor([prompt], device="cuda"), b.cache, 0,
                    frames=fr)
    worst, worst_cold, argmax_equal = 0.0, float("inf"), 0
    for i in range(MLA_DECODE_STEPS):
        toks = torch.zeros((N_SLOTS, 1), dtype=torch.int64, device="cuda")
        toks[0, 0] = seq[n + i]
        pos = torch.full((N_SLOTS,), n + i, device="cuda")
        step = b.model.decode_step(b.params, toks, b.cache, pos)[:1]
        full = b.model.prefill(b.params, torch.tensor([seq[: n + i + 1]], device="cuda"),
                               b.cache, 1, frames=fr)
        require(bool(torch.isfinite(step).all() and torch.isfinite(full).all()),
                "phase 14 (b): decode-consistency logits hold NaN or inf")
        scale = float(full.abs().max())
        diff = float((step - full).abs().max())
        worst = max(worst, diff / scale)
        argmax_equal += int(step.argmax()) == int(full.argmax())
        require(diff <= HANDOFF_TOL * scale,
                f"phase 14 (b): decode step {i} {diff:.4g} > {HANDOFF_TOL} x {scale:.4g}")
        if i == MLA_DECODE_STEPS - 1:
            for t in (b.cache.self_kv.k, b.cache.self_kv.v, b.cache.cross.k,
                      b.cache.cross.v):
                t[:, 0].zero_()
            cold = b.model.decode_step(b.params, toks, b.cache, pos)[:1]
            cold_diff = float((cold - full).abs().max())
            worst_cold = cold_diff / scale
            require(cold_diff >= HANDOFF_CONTROL * diff,
                    f"phase 14 (b): a zeroed slot moves the logits by "
                    f"{cold_diff:.4g}, under {HANDOFF_CONTROL} x {diff:.4g}")
    log(f"phase 14 (b): {MLA_DECODE_STEPS} decode steps after a {n}-token prefill "
        f"against full prefills: worst max |decode - prefill| {worst:.4f} of max "
        f"|logit| (gate {HANDOFF_TOL}); argmax equal in {argmax_equal} of "
        f"{MLA_DECODE_STEPS}; from a zeroed slot {worst_cold:.4f}")


def whisper_phase(torch) -> dict[str, int]:
    """Phase 14, the enc-dec family, after phase 13 has freed its weights:
    full-width whisper-large-v3 (32 encoder and 32 decoder layers, 20
    heads of 64, 1,500 frames, tied vocab 51,866) with random bf16 weights
    (seed 0), served through the port's ``ContinuousBatcher`` with each
    request's frames in ``Request.extras`` (16 slots of 1,024 self rows
    and 1,500 cross rows).  (a) ``WHISPER_ROWS`` of phase 2's QA prompts,
    32 new tokens each, greedy: every request completes, kernel 1 launches
    96 times a prompt and kernel 2 64 times a decode step, exactly; (b) a
    request alone in a reused slot and in a fresh batcher gives its tokens
    among the rest; 4 decode steps after a prefill against full prefills; one
    encoder and one decoder layer through the kernels against their plain
    versions; the breakdowns of a prefill and a decode step; (c) a paged
    batcher refused with the reference's words, and the local engine
    refusing whisper.  Returns (a)'s launches."""
    from repro_torch.configs import get_config
    from repro_torch.core import DataConfig, EngineModelConfig, TorchLocalEngine
    from repro_torch.data import HashTokenizer, iter_qa_examples, render
    from repro_torch.models import EncDecLM, init_params
    from repro_torch.serve import ContinuousBatcher, Request

    cfg = get_config(WHISPER)
    log(f"phase 14: {gib(torch.cuda.memory_allocated())} allocated before the weights")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"phase 14 weights on the card in {time.perf_counter() - t0:.3f} s: "
        f"{n_params / 1e9:.3f} B parameters, "
        f"{gib(sum(t.numel() * t.element_size() for t in _leaves(params)))} of "
        f"weights, {gib(torch.cuda.max_memory_allocated())} peak while made")
    tok = HashTokenizer(cfg.vocab_size)
    rows = list(iter_qa_examples(WHISPER_ROWS, seed=0))
    prompts = [tok.encode(render(DataConfig().prompt_template, r)) for r in rows]
    frames = whisper_frames(WHISPER_ROWS, cfg.d_model)

    def requests(ids):
        return [Request(i, prompts[i], MAX_TOKENS, {"frames": frames[i]}) for i in ids]

    t_a = time.perf_counter()
    b = whisper_batcher(cfg, params, tok.eos_id)
    cache_bytes = 4 * sum(t.numel() for t in (b.cache.self_kv.k, b.cache.self_kv.v,
                                              b.cache.cross.k, b.cache.cross.v))
    log(f"phase 14 caches: {gib(cache_bytes)} for {N_SLOTS} slots x ({MAX_LEN} self + "
        f"{WHISPER_FRAMES} cross rows); prompts {min(map(len, prompts))}-"
        f"{max(map(len, prompts))} tokens")
    tokens, launches = batcher_serve(torch, b, requests(range(WHISPER_ROWS)),
                                     "phase 14 (a) enc-dec path")
    log(f"phase 14 (a): {gib(torch.cuda.max_memory_allocated())} peak allocated")

    t_b = time.perf_counter()
    probe_id = WHISPER_ROWS - 3
    alone, _ = batcher_serve(torch, b, requests([probe_id]), "phase 14 (b) alone")
    require(alone[probe_id] == tokens[probe_id],
            f"phase 14 (b): request {probe_id} alone in slot 0 gives other tokens "
            f"than among {WHISPER_ROWS}: {alone[probe_id]} vs {tokens[probe_id]}")
    fresh_b = whisper_batcher(cfg, params, tok.eos_id)
    fresh, _ = batcher_serve(torch, fresh_b, requests([probe_id]),
                             "phase 14 (b) fresh batcher")
    require(fresh[probe_id] == tokens[probe_id],
            f"phase 14 (b): a fresh batcher gives other tokens: {fresh[probe_id]}")
    del fresh_b
    free_cuda(torch)
    log(f"phase 14 (b) batch invariance and slot reuse: request {probe_id}'s "
        f"{len(tokens[probe_id])} tokens equal alone in a reused slot (slot 0 held "
        f"request 0), in a fresh batcher and among {WHISPER_ROWS}")
    whisper_consistency_gate(torch, b, prompts[0], frames[0])
    fr = torch.from_numpy(frames[0]).cuda()[None]
    toks = torch.tensor([prompts[0]], device="cuda")
    step_breakdown(torch, f"phase 14 prefill ({len(prompts[0])} tokens and "
                   f"{WHISPER_FRAMES} frames into slot 0)",
                   lambda: b.model.prefill(b.params, toks, b.cache, 0, frames=fr),
                   kernel="flash")
    nxt = torch.full((N_SLOTS, 1), 7, dtype=torch.int64, device="cuda")
    pos = torch.full((N_SLOTS,), PROMPT_LEN, dtype=torch.int64, device="cuda")
    step_breakdown(torch, f"phase 14 decode step (batch {N_SLOTS}, positions "
                   f"{PROMPT_LEN})",
                   lambda: b.model.decode_step(b.params, nxt, b.cache, pos),
                   kernel=DEVICE_KERNEL["decode_attention"])
    del b
    free_cuda(torch)
    whisper_layer_gate(torch, params, frames[0], prompts[0])

    t_c = time.perf_counter()
    try:
        ContinuousBatcher(EncDecLM(cfg), cfg, params, n_slots=N_SLOTS, max_len=MAX_LEN,
                          page_size=PAGE_SIZE)
    except ValueError as e:
        require(str(e) == "paged KV cache supports GQA attention families "
                "('dense', 'moe'), not encdec", f"phase 14 (c): another error: {e}")
        log(f"phase 14 (c): a paged batcher raises the reference's error: {e}")
    else:
        raise CheckFailed("phase 14 (c): a paged enc-dec batcher was built")
    engine = TorchLocalEngine(EngineModelConfig(provider="torch_local",
                                                model_name=WHISPER, reduced=False),
                              n_slots=N_SLOTS, max_len=MAX_LEN, device="cuda",
                              params=params)
    try:
        engine.initialize()
    except ValueError as e:
        require("cannot carry the encoder frames" in str(e),
                f"phase 14 (c): another engine error: {e}")
        log(f"phase 14 (c): the local engine refuses whisper: {e}")
    else:
        raise CheckFailed("phase 14 (c): the local engine took whisper")
    log(f"phase 14 walls: (a) {t_b - t_a:.1f} s, (b) {t_c - t_b:.1f} s, "
        f"(c) {time.perf_counter() - t_c:.1f} s; "
        f"{gib(torch.cuda.max_memory_allocated())} peak allocated")
    return launches


# -- phase 15: the VLM family ------------------------------------------------------

#: phase 15: the seed of the requests' patch embeddings (each (256, 2,048)
#: bf16, drawn on the card at 0.02 scale, as the reference's tests draw
#: them) and of the layer gate's inputs; its requests: half a chunk, as
#: phase 14's
PALI_SEED = 15
PALI_ROWS = CHUNK // 2


def pali_patches(torch, n: int, d_model: int, seed: int = PALI_SEED) -> list:
    """``n`` requests' patch embeddings, (256, d_model) bf16 each, made on
    the card from ``seed``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [(0.02 * torch.randn((PALI_PREFIX, d_model), generator=g, device="cuda"))
            .to(torch.bfloat16) for _ in range(n)]


def pali_batcher(cfg, params, eos_id: int):
    """Phase 15's batcher: ``N_SLOTS`` slots of ``PALI_MAX_LEN`` rows."""
    from repro_torch.models import TransformerLM
    from repro_torch.serve import ContinuousBatcher

    return ContinuousBatcher(TransformerLM(cfg), cfg, params, n_slots=N_SLOTS,
                             max_len=PALI_MAX_LEN, eos_id=eos_id)


def pali_layer_gate(torch, params, patches, prompt: list[int]) -> None:
    """Phase 15 (b), a layer: layer 0's prefill over the 256 patches and
    ``prompt`` (kernel 1 under the prefix-LM mask, then the GeGLU MLP) and
    one decode step of its attention over 16 slots at phase 15's positions
    (kernel 2 over random cache rows), through the kernels against the same
    code through their plain versions on the card, both bf16; the cache
    rows the two paths write are gated bit-equal."""
    import repro_torch.models.attention as attn_mod
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention_ref
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.models import TransformerLM, layers
    from repro_torch.models.model import _block

    cfg = get_config(PALIGEMMA)
    lm = TransformerLM(cfg)
    p = _block(params["layers"], 0)
    n = PALI_PREFIX + len(prompt)
    toks = torch.tensor([prompt], device="cuda")
    x = torch.cat([patches[None], lm._embed(params, toks, torch.bfloat16)], dim=1)
    rope = lm._rope(torch.arange(n, device="cuda")[None, :])
    g = torch.Generator(device="cuda").manual_seed(PALI_SEED)
    step_x = torch.randn((N_SLOTS, 1, cfg.d_model), generator=g, device="cuda").to(
        torch.bfloat16)
    pos = n + 2 * torch.arange(N_SLOTS, device="cuda")
    lengths = (pos + 1).to(torch.int32)
    step_rope = lm._rope(pos[:, None])

    def run():
        kv = torch.zeros((4, N_SLOTS, PALI_MAX_LEN, cfg.n_kv_heads, cfg.head_dim),
                         device="cuda")
        h = layers.rms_norm(p["ln1"], x, cfg.norm_eps)
        a = x + attn_mod.gqa_prefill(p["attn"], cfg, h, kv[0], kv[1], 0, rope,
                                     prefix_len=PALI_PREFIX)
        y = a + layers.gated_mlp(p["mlp"], layers.rms_norm(p["ln2"], a, cfg.norm_eps),
                                 cfg.act)
        kv[2:].normal_(generator=g)
        hs = layers.rms_norm(p["ln1"], step_x, cfg.norm_eps)
        d_out = attn_mod.gqa_decode(p["attn"], cfg, hs, kv[2], kv[3], pos, lengths,
                                    step_rope)
        return y, d_out, kv

    g.manual_seed(PALI_SEED + 1)
    got = run()
    flash, dec_fn = attn_mod.flash_attention_bshd, attn_mod.decode_attention_bshd
    attn_mod.flash_attention_bshd = flash_attention_ref
    attn_mod.decode_attention_bshd = decode_attention_ref
    try:
        g.manual_seed(PALI_SEED + 1)
        want = run()
    finally:
        attn_mod.flash_attention_bshd, attn_mod.decode_attention_bshd = flash, dec_fn
    torch.cuda.synchronize()
    ratios = []
    for name, a, b in zip(("prefill layer", "decode attention"), got, want):
        err, ratio = rowwise(torch, a, b, HYBRID_LAYER_TOL, HYBRID_LAYER_TOL)
        require(ratio <= 1.0, f"phase 15 (b) {name}: error/allowance {ratio:.3g}")
        ratios.append(f"{name} err {err:.3g} (ratio {ratio:.3g})")
    require(bool(torch.equal(got[2], want[2])),
            "phase 15 (b): the cache rows depend on the attention path")
    log(f"phase 15 (b): layer 0 over {PALI_PREFIX} patches and {len(prompt)} tokens "
        f"(kernel 1 at d = 256 with prefix_len {PALI_PREFIX}) and one {N_SLOTS}-slot "
        f"decode step at lengths {int(lengths[0])}..{int(lengths[-1])} (kernel 2 at "
        f"d = 256, G = 8) against their plain versions: " + "; ".join(ratios))


def pali_consistency_gate(torch, b, prompt: list[int], patches) -> None:
    """Phase 15 (b), the decode: slot 0 prefilled with ``patches`` and
    ``prompt``, then ``MLA_DECODE_STEPS`` decode steps of every slot
    feeding the next tokens at positions after the prefix; each step's
    logits of slot 0 against a full prefill of the prompt and the tokens so
    far (into slot 1, the same patches), and against the same step from a
    zeroed slot 0 (the control)."""
    n = len(prompt)
    pt = patches[None]
    seq = prompt + [int(t) for t in torch.randint(
        4, b.cfg.vocab_size, (MLA_DECODE_STEPS,),
        generator=torch.Generator().manual_seed(PALI_SEED))]
    b.model.prefill(b.params, torch.tensor([prompt], device="cuda"), b.cache, 0,
                    patches=pt)
    worst, worst_cold, argmax_equal = 0.0, float("inf"), 0
    for i in range(MLA_DECODE_STEPS):
        toks = torch.zeros((N_SLOTS, 1), dtype=torch.int64, device="cuda")
        toks[0, 0] = seq[n + i]
        pos = torch.full((N_SLOTS,), PALI_PREFIX + n + i, device="cuda")
        step = b.model.decode_step(b.params, toks, b.cache, pos)[:1]
        full = b.model.prefill(b.params, torch.tensor([seq[: n + i + 1]], device="cuda"),
                               b.cache, 1, patches=pt)
        require(bool(torch.isfinite(step).all() and torch.isfinite(full).all()),
                "phase 15 (b): decode-consistency logits hold NaN or inf")
        scale = float(full.abs().max())
        diff = float((step - full).abs().max())
        worst = max(worst, diff / scale)
        argmax_equal += int(step.argmax()) == int(full.argmax())
        require(diff <= HANDOFF_TOL * scale,
                f"phase 15 (b): decode step {i} {diff:.4g} > {HANDOFF_TOL} x {scale:.4g}")
        if i == MLA_DECODE_STEPS - 1:
            for t in (b.cache.k, b.cache.v):
                t[:, 0].zero_()
            cold = b.model.decode_step(b.params, toks, b.cache, pos)[:1]
            cold_diff = float((cold - full).abs().max())
            worst_cold = cold_diff / scale
            require(cold_diff >= HANDOFF_CONTROL * diff,
                    f"phase 15 (b): a zeroed slot moves the logits by "
                    f"{cold_diff:.4g}, under {HANDOFF_CONTROL} x {diff:.4g}")
    log(f"phase 15 (b): {MLA_DECODE_STEPS} decode steps after a {PALI_PREFIX} + {n}-token "
        f"prefill against full prefills: worst max |decode - prefill| {worst:.4f} of "
        f"max |logit| (gate {HANDOFF_TOL}); argmax equal in {argmax_equal} of "
        f"{MLA_DECODE_STEPS}; from a zeroed slot {worst_cold:.4f}")


def paligemma_phase(torch) -> dict[str, int]:
    """Phase 15, the VLM family, after phase 14 has freed its weights:
    full-width paligemma-3b (18 layers, 8 heads of 256 over 1 KV head, d_ff
    16,384, tied vocab 257,216, the SigLIP frontend stubbed) with random
    bf16 weights (seed 0), served through the port's ``ContinuousBatcher``
    with each request's (256, 2,048) patch embeddings in
    ``Request.extras`` (16 slots of 512 rows).  (a) ``PALI_ROWS`` of phase
    2's QA prompts, 32 new tokens each, greedy: every request completes,
    kernel 1 launches once a layer a prompt (under the prefix-LM mask) and
    kernel 2 once a layer a decode step, exactly; (b) a request alone in a
    reused slot and in a fresh batcher gives its tokens among the rest; 4
    decode steps after a prefill against full prefills; the breakdowns of
    a prefill and a decode step; layer 0 through the kernels against their
    plain versions; (c) a paged batcher and a suffix prefill refused with
    the reference's words, and the local engine refusing paligemma.
    Returns (a)'s launches."""
    from repro_torch.configs import get_config
    from repro_torch.core import DataConfig, EngineModelConfig, TorchLocalEngine
    from repro_torch.data import HashTokenizer, iter_qa_examples, render
    from repro_torch.models import TransformerLM, init_params
    from repro_torch.serve import ContinuousBatcher, Request

    cfg = get_config(PALIGEMMA)
    require((cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_vision_tokens)
            == (PALI_HEADS, PALI_KV_HEADS, PALI_HEAD_DIM, PALI_PREFIX),
            f"phase 15: {cfg.name}'s geometry is not phase 1's")
    log(f"phase 15: {gib(torch.cuda.memory_allocated())} allocated before the weights")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"phase 15 weights on the card in {time.perf_counter() - t0:.3f} s: "
        f"{n_params / 1e9:.3f} B parameters, "
        f"{gib(sum(t.numel() * t.element_size() for t in _leaves(params)))} of "
        f"weights, {gib(torch.cuda.max_memory_allocated())} peak while made")
    tok = HashTokenizer(cfg.vocab_size)
    rows = list(iter_qa_examples(PALI_ROWS, seed=0))
    prompts = [tok.encode(render(DataConfig().prompt_template, r)) for r in rows]
    patches = pali_patches(torch, PALI_ROWS, cfg.d_model)

    def requests(ids):
        return [Request(i, prompts[i], MAX_TOKENS, {"patches": patches[i]}) for i in ids]

    t_a = time.perf_counter()
    b = pali_batcher(cfg, params, tok.eos_id)
    cache_bytes = 4 * sum(t.numel() for t in (b.cache.k, b.cache.v))
    log(f"phase 15 cache: {gib(cache_bytes)} for {N_SLOTS} slots x {PALI_MAX_LEN} rows; "
        f"{PALI_PREFIX} patch rows and prompts of {min(map(len, prompts))}-"
        f"{max(map(len, prompts))} tokens")
    tokens, launches = batcher_serve(torch, b, requests(range(PALI_ROWS)),
                                     "phase 15 (a) VLM path", cfg.n_layers, cfg.n_layers)
    log(f"phase 15 (a): {gib(torch.cuda.max_memory_allocated())} peak allocated")

    t_b = time.perf_counter()
    probe_id = PALI_ROWS - 3
    alone, _ = batcher_serve(torch, b, requests([probe_id]), "phase 15 (b) alone",
                             cfg.n_layers, cfg.n_layers)
    require(alone[probe_id] == tokens[probe_id],
            f"phase 15 (b): request {probe_id} alone in slot 0 gives other tokens "
            f"than among {PALI_ROWS}: {alone[probe_id]} vs {tokens[probe_id]}")
    fresh_b = pali_batcher(cfg, params, tok.eos_id)
    fresh, _ = batcher_serve(torch, fresh_b, requests([probe_id]),
                             "phase 15 (b) fresh batcher", cfg.n_layers, cfg.n_layers)
    require(fresh[probe_id] == tokens[probe_id],
            f"phase 15 (b): a fresh batcher gives other tokens: {fresh[probe_id]}")
    del fresh_b
    free_cuda(torch)
    log(f"phase 15 (b) batch invariance and slot reuse: request {probe_id}'s "
        f"{len(tokens[probe_id])} tokens equal alone in a reused slot (slot 0 held "
        f"request 0), in a fresh batcher and among {PALI_ROWS}")
    pali_consistency_gate(torch, b, prompts[0], patches[0])
    toks = torch.tensor([prompts[0]], device="cuda")
    step_breakdown(torch, f"phase 15 prefill ({PALI_PREFIX} patches and "
                   f"{len(prompts[0])} tokens into slot 0)",
                   lambda: b.model.prefill(b.params, toks, b.cache, 0,
                                           patches=patches[0][None]),
                   kernel="flash")
    nxt = torch.full((N_SLOTS, 1), 7, dtype=torch.int64, device="cuda")
    pos = torch.full((N_SLOTS,), PALI_PREFIX + PROMPT_LEN, dtype=torch.int64,
                     device="cuda")
    step_breakdown(torch, f"phase 15 decode step (batch {N_SLOTS}, positions "
                   f"{PALI_PREFIX + PROMPT_LEN})",
                   lambda: b.model.decode_step(b.params, nxt, b.cache, pos),
                   kernel=DEVICE_KERNEL["decode_attention"])
    del b
    free_cuda(torch)
    pali_layer_gate(torch, params, patches[0], prompts[0])

    t_c = time.perf_counter()
    try:
        ContinuousBatcher(TransformerLM(cfg), cfg, params, n_slots=N_SLOTS,
                          max_len=PALI_MAX_LEN, page_size=PAGE_SIZE)
    except ValueError as e:
        require(str(e) == "paged KV cache supports GQA attention families "
                "('dense', 'moe'), not vlm", f"phase 15 (c): another error: {e}")
        log(f"phase 15 (c): a paged batcher raises the reference's error: {e}")
    else:
        raise CheckFailed("phase 15 (c): a paged VLM batcher was built")
    lm = TransformerLM(cfg)
    try:
        lm.prefill(params, torch.tensor([prompts[0]], device="cuda"),
                   lm.init_cache(1, PALI_MAX_LEN, "cuda"), 0, start=PAGE_SIZE,
                   patches=patches[0][None])
    except ValueError as e:
        require(str(e) == "suffix prefill is not supported for VLM prompts",
                f"phase 15 (c): another suffix-prefill error: {e}")
        log(f"phase 15 (c): a suffix prefill raises the reference's error: {e}")
    else:
        raise CheckFailed("phase 15 (c): a VLM suffix prefill ran")
    engine = TorchLocalEngine(EngineModelConfig(provider="torch_local",
                                                model_name=PALIGEMMA, reduced=False),
                              n_slots=N_SLOTS, max_len=PALI_MAX_LEN, device="cuda",
                              params=params)
    try:
        engine.initialize()
    except ValueError as e:
        require("cannot carry the patch embeddings" in str(e),
                f"phase 15 (c): another engine error: {e}")
        log(f"phase 15 (c): the local engine refuses paligemma: {e}")
    else:
        raise CheckFailed("phase 15 (c): the local engine took paligemma")
    log(f"phase 15 walls: (a) {t_b - t_a:.1f} s, (b) {t_c - t_b:.1f} s, "
        f"(c) {time.perf_counter() - t_c:.1f} s; "
        f"{gib(torch.cuda.max_memory_allocated())} peak allocated")
    return launches


# -- phase 16: training and checkpoints ------------------------------------------

#: phase 16 (a): full-width qwen3-4b trained from f32 master weights made on
#: the card from ``TRAIN_SEED``: one seeded batch of ``TRAIN_BATCH`` rows x
#: ``TRAIN_SEQ`` tokens, repeated for ``TRAIN_STEPS`` steps, bf16 compute,
#: one microbatch (M > 1 would add a 16 GB f32 accumulator), every block
#: recomputed in the backward pass (``remat="full"``, what the reference
#: launches at full width), AdamW at a constant ``TRAIN_LR`` without warmup
TRAIN_SEED = 16
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 64, 4
TRAIN_REMAT, TRAIN_LR = "full", 1e-4
#: (a)'s forward check: a prompt of ``TRAIN_PROMPT`` tokens through the
#: training forward (plain attention, bf16) against the serving prefill of
#: each of its prefixes (kernel 1) on a bf16 copy of the same weights; every
#: position's logits within ``TRAIN_FWD_TOL`` of the prompt's largest |logit|
TRAIN_PROMPT = 16
TRAIN_FWD_TOL = 2.0**-4
#: phase 16 (b): reduced qwen3-4b in f32 through ``simulate_training``: the
#: steps, the step after which the run crashes, the checkpoint period
CKPT_STEPS, CKPT_CRASH, CKPT_EVERY = 6, 3, 2


def _map_tree(fn, tree):
    return {k: _map_tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def train_forward_gate(torch, cfg, masters) -> None:
    """Phase 16 (a), before training: the training forward over one prompt
    on the f32 masters (cast to bf16 at each use) against the serving
    ``prefill`` of every prefix of the prompt on a bf16 copy of them
    (kernel 1 once a layer a prefill, exactly), the copy freed after."""
    from repro_torch.models import TransformerLM
    from repro_torch.models.params import _map_specs, param_specs

    def cast(node, kinds):
        """Matrices to bf16, as ``init_params`` stores them for serving;
        the rest (norm scales) shared with the masters."""
        return {k: cast(v, kinds[k]) if isinstance(v, dict) else
                (v.to(torch.bfloat16) if kinds[k] == "matrix" else v)
                for k, v in node.items()}

    serving = cast(masters, _map_specs(lambda path, spec: spec[1], param_specs(cfg)))
    lm = TransformerLM(cfg, remat="none")
    g = torch.Generator(device="cuda").manual_seed(TRAIN_SEED)
    toks = torch.randint(4, cfg.vocab_size, (1, TRAIN_PROMPT), generator=g, device="cuda")
    zero_counts()
    with torch.no_grad():
        train, aux = lm.forward(masters, {"tokens": toks}, dtype=torch.bfloat16)
        cache = lm.init_cache(1, TRAIN_PROMPT, "cuda")
        serve = torch.cat([lm.prefill(serving, toks[:, : i + 1], cache, 0)
                           for i in range(TRAIN_PROMPT)])
    torch.cuda.synchronize()
    launches = read_counts()
    del serving, cache
    free_cuda(torch)
    require(launches["flash_attention"] == TRAIN_PROMPT * cfg.n_layers,
            f"phase 16 (a): {launches['flash_attention']} prefill kernel launches, not "
            f"{TRAIN_PROMPT} x {cfg.n_layers}")
    require(bool(torch.isfinite(train).all() and torch.isfinite(serve).all())
            and float(aux) == 0.0, "phase 16 (a): forward logits hold NaN or inf")
    require(tuple(train.shape) == (1, TRAIN_PROMPT, cfg.padded_vocab),
            f"phase 16 (a): forward logits of shape {tuple(train.shape)}")
    scale = float(serve.abs().max())
    per_pos = (train[0] - serve).abs().amax(dim=-1) / scale
    argmax_equal = int((train[0].argmax(-1) == serve.argmax(-1)).sum())
    require(float(per_pos.max()) <= TRAIN_FWD_TOL,
            f"phase 16 (a): training forward against the serving prefill "
            f"{float(per_pos.max()):.4g} of max |logit| > {TRAIN_FWD_TOL}")
    log(f"phase 16 (a): the training forward (plain attention, bf16 casts of the f32 "
        f"masters) against {TRAIN_PROMPT} serving prefills (kernel 1, "
        f"{launches['flash_attention']} launches, stored bf16 weights): worst position "
        f"{float(per_pos.max()):.4f} of max |logit| {scale:.4g} (gate {TRAIN_FWD_TOL}), "
        f"mean {float(per_pos.mean()):.4f}; argmax equal at {argmax_equal} of "
        f"{TRAIN_PROMPT} positions")


def train_full_width(torch) -> None:
    """Phase 16 (a): full-width qwen3-4b (36 layers, d 2,560, tied vocab
    151,936), f32 masters on the card, the forward gate, then
    ``TRAIN_STEPS`` steps of ``make_train_step``: every loss and gradient
    norm finite and the last loss below the first; then the breakdown of
    a further step (three more steps: a warm-up, one timed, one
    profiled)."""
    from repro_torch.configs import get_config
    from repro_torch.models import TransformerLM, init_params
    from repro_torch.train import OptimizerConfig, TrainConfig, init_opt_state, make_train_step

    cfg = get_config("qwen3-4b")
    log(f"phase 16: {gib(torch.cuda.memory_allocated())} allocated before the masters")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    masters = init_params(cfg, TRAIN_SEED, device="cuda", dtype=torch.float32)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(masters))
    log(f"phase 16 (a): f32 masters on the card in {time.perf_counter() - t0:.3f} s: "
        f"{n_params / 1e9:.4f} B parameters, {gib(4 * n_params)}")
    train_forward_gate(torch, cfg, masters)

    torch.cuda.reset_peak_memory_stats()
    opt = init_opt_state(masters)
    tcfg = TrainConfig(optimizer=OptimizerConfig(learning_rate=TRAIN_LR, warmup_steps=0,
                                                 schedule="constant"))
    step = make_train_step(TransformerLM(cfg, remat=TRAIN_REMAT), cfg, tcfg)
    g = torch.Generator(device="cuda").manual_seed(TRAIN_SEED + 1)
    toks = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1), generator=g,
                         device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    losses, norms, walls = [], [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        masters, opt, metrics = step(masters, opt, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    peak = torch.cuda.max_memory_allocated()
    require(all(math.isfinite(x) for x in losses + norms),
            f"phase 16 (a): a loss or gradient norm is not finite: {losses}, {norms}")
    require(int(opt.step) == TRAIN_STEPS, f"phase 16 (a): optimizer step {int(opt.step)}")
    require(losses[-1] < losses[0],
            f"phase 16 (a): the loss did not fall over {TRAIN_STEPS} steps: {losses}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"phase 16 (a): {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens, remat "
        f"{TRAIN_REMAT}, bf16 compute, lr {TRAIN_LR}: losses "
        f"{', '.join(f'{x:.6f}' for x in losses)}; gradient norms "
        f"{', '.join(f'{x:.4f}' for x in norms)}; step walls "
        f"{', '.join(f'{1e3 * w:.1f}' for w in walls)} ms ({tokens / walls[-1]:.0f} "
        f"tokens/s at the last, {tokens * len(walls[1:]) / sum(walls[1:]):.0f} over steps "
        f"2-{TRAIN_STEPS}); {gib(peak)} peak allocated while training (masters, "
        f"gradients and two moments: {gib(16 * n_params)})")
    step_breakdown(torch, f"phase 16 (a) training step ({TRAIN_BATCH} x {TRAIN_SEQ} "
                   f"tokens, remat {TRAIN_REMAT})", lambda: step(masters, opt, batch),
                   steps=1)
    del masters, opt, step, batch, metrics


def train_resume(torch) -> None:
    """Phase 16 (b): reduced qwen3-4b in f32 through ``simulate_training``,
    checkpoints in a temporary directory: a run crashed after step
    ``CKPT_CRASH`` and resumed from its latest checkpoint ends bit-equal to
    the uninterrupted run."""
    import tempfile

    from repro_torch.ckpt import latest_step
    from repro_torch.configs import get_config
    from repro_torch.ft import simulate_training
    from repro_torch.models import TransformerLM, init_params
    from repro_torch.train import OptimizerConfig, TrainConfig, init_opt_state, make_train_step

    cfg = get_config("qwen3-4b").reduced()
    init = init_params(cfg, TRAIN_SEED, device="cuda", dtype=torch.float32)
    step = make_train_step(TransformerLM(cfg, remat=TRAIN_REMAT), cfg,
                           TrainConfig(compute_dtype=torch.float32,
                                       optimizer=OptimizerConfig(warmup_steps=0)))
    g = torch.Generator(device="cuda").manual_seed(TRAIN_SEED + 2)
    toks = torch.randint(0, cfg.vocab_size, (CKPT_STEPS, 2, 33), generator=g, device="cuda")
    batches = [{"tokens": t[:, :-1], "labels": t[:, 1:]} for t in toks]

    def fresh():
        p = _map_tree(torch.clone, init)
        return (p, init_opt_state(p))

    def train(state, batch):
        return step(*state, batch)[:2]

    run = dict(ckpt_every=CKPT_EVERY, family=cfg.family)
    with tempfile.TemporaryDirectory() as tmp:
        whole = simulate_training(train, fresh(), batches, ckpt_dir=f"{tmp}/a", **run)
        crashed = simulate_training(train, fresh(), batches, ckpt_dir=f"{tmp}/b",
                                    crash_at_step=CKPT_CRASH, **run)
        resumed_from = latest_step(f"{tmp}/b")
        resumed = simulate_training(train, fresh(), batches, ckpt_dir=f"{tmp}/b", **run)
    require(crashed is None and resumed_from == CKPT_CRASH - CKPT_CRASH % CKPT_EVERY,
            f"phase 16 (b): the crashed run left step {resumed_from}")
    pairs = list(zip(_leaves(whole[0]), _leaves(resumed[0])))
    pairs += list(zip(_leaves(whole[1].mu), _leaves(resumed[1].mu)))
    pairs += list(zip(_leaves(whole[1].nu), _leaves(resumed[1].nu)))
    differ = sum(not torch.equal(a, b) for a, b in pairs)
    require(int(resumed[1].step) == int(whole[1].step) == CKPT_STEPS,
            f"phase 16 (b): steps {int(resumed[1].step)}, {int(whole[1].step)}")
    require(differ == 0, f"phase 16 (b): {differ} of {len(pairs)} leaves of the resumed "
            f"run differ from the uninterrupted run's")
    log(f"phase 16 (b): reduced qwen3-4b, {CKPT_STEPS} f32 steps, a checkpoint every "
        f"{CKPT_EVERY}: crashed after step {CKPT_CRASH}, resumed from step "
        f"{resumed_from}; all {len(pairs)} leaves (parameters, moments) bit-equal to "
        f"the uninterrupted run's (deterministic algorithms "
        f"{'on' if torch.are_deterministic_algorithms_enabled() else 'off'})")


def training_phase(torch) -> None:
    """Phase 16, the training slice, last (after phase 15 has freed its
    weights): (a) full-width qwen3-4b trained on the card; (b) a crash and
    a resume through ``simulate_training``."""
    t0 = time.perf_counter()
    train_full_width(torch)
    free_cuda(torch)
    t1 = time.perf_counter()
    train_resume(torch)
    log(f"phase 16 walls: (a) {t1 - t0:.1f} s, (b) {time.perf_counter() - t1:.1f} s")


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    from repro_torch.kernels import _cuda

    t0 = time.perf_counter()
    _cuda.library()
    log(f"kernel library ready in {time.perf_counter() - t0:.1f} s")
    t_start = time.perf_counter()

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        free_cuda(torch)
        log(f"{label} took {time.perf_counter() - t0:.1f} s")
        return out

    try:
        fs = FewShot()
        entries = timed("phase 1", kernel_phase, torch, fs)
        contiguous, metrics, yard = timed("phases 2, 5 and 7", main_path_phase, torch)
        paged = timed("phase 3", paged_phase, torch, fs)
        mamba = timed("phase 4", mamba_phase, torch, fs)
        t6 = time.perf_counter()
        suite_phase(torch)
        log(f"phases 6 and 8 took {time.perf_counter() - t6:.1f} s")
        timed("phase 9", fabric_phase, torch, yard)
        del yard
        moe_runs = timed("phase 10", moe_phase, torch, fs)
        qwen25_runs = timed("phase 11", qwen25_phase, torch, fs)
        hybrid = timed("phase 12", zamba_phase, torch, fs)
        mla = timed("phase 13", minicpm_phase, torch, fs)
        whisper = timed("phase 14", whisper_phase, torch)
        pali = timed("phase 15", paligemma_phase, torch)
        timed("phase 16", training_phase, torch)
    except CheckFailed as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    # each kernel's launches on the path it carries: the contiguous main path
    # for flash, decode and bootstrap partials, the paged runs for the paged
    # kernels, the Mamba2 run for ssd, the metrics path for bertscore and the
    # statistics API for the bootstrap means
    launches = {**contiguous,
                "paged_decode_attention": paged["f32"]["paged_decode_attention"],
                "quant_paged_decode_attention":
                    paged["int8"]["quant_paged_decode_attention"],
                "ssd": mamba["ssd"],
                "bertscore_pr": metrics["bertscore_pr"],
                "bootstrap_means": metrics["bootstrap_means"]}
    # and phase 10's runs on the MoE model and phase 11's on qwen2.5-32b, for
    # the four attention kernels; phase 12's on zamba2-7b for kernels 1, 2, 8
    for name in MOE_KERNELS:
        launches[name] += sum(run[name] for run in (*moe_runs.values(),
                                                    *qwen25_runs.values()))
    for name in ("flash_attention", "decode_attention", "ssd"):
        launches[name] += hybrid[name]
    # and phase 13's on minicpm3-4b for kernel 1 (kernel 2 launches none);
    # phase 14's on whisper-large-v3 and phase 15's on paligemma-3b for
    # kernels 1 and 2
    launches["flash_attention"] += mla["flash_attention"]
    for name in ("flash_attention", "decode_attention"):
        launches[name] += whisper[name] + pali[name]
    for e in entries:
        e["launches"] = launches[e["name"]]
    for e in entries:
        for key in ("ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err"):
            if e[key] is not None and not math.isfinite(e[key]):
                print(f"chip_smoke: FAIL: {e['name']} {key} = {e[key]}",
                      file=sys.stderr)
                return 1
    log(f"phases 1-16 took {time.perf_counter() - t_start:.1f} s after the build")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
