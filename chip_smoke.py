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
is also held and timed at the main path's own lengths (11..45).  Every task of phases
2-5 streams (``StreamingConfig(enabled=True)``) unless it says otherwise.
Phase 2
runs the contiguous main path through the user's entry point,
``EvalSession.run_task``, on full-width qwen3-4b with random bf16 weights,
and checks that its kernels
launched there, that the greedy tokens of a prompt do not depend on the
batch around it, and that the logits are finite.  Phase 3 runs the paged
path: ``run_task`` over few-shot prompts (a ~464-token header of worked
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
single-flight over 64 rows of 16 prompts (16 engine calls, 48 coalesced);
kernels 1, 2, 6, 7 and 8 must launch in the phase.

Standard output: the card's name and power limit first, then log lines,
then one ``{"kernels": [...]}`` line, and last the
``{"ok": true, "device": ...}`` line.  Any failed check exits non-zero
without the last line.  Without a CUDA device, or outside a checkout, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
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

#: the main path of phase 2: QA rows, rows per chunk, batcher slots, cache
#: positions per slot, new tokens per prompt, bootstrap replicates
N_ROWS, CHUNK, N_SLOTS, MAX_LEN, MAX_TOKENS, N_BOOT = 64, 16, 16, 1024, 32, 1000
#: a main-path prompt's length (the QA prompts render to 10-13 tokens)
PROMPT_LEN = 12
#: phase 3: tokens per KV page, and the few-shot header's token range
PAGE_SIZE = 16
HEADER_TOKENS = (448, 480)
#: phase 1's prefill shapes (Sq, Sk, q_offset); the last is phase 3's suffix
#: prefill after a prefix-cache hit (478 tokens, 464 shared; FewShot checks)
FLASH_SHAPES = ((PROMPT_LEN, PROMPT_LEN, 0), (37, 37, 0), (512, 512, 0),
                (2048, 2048, 0), (512, 2048, 1536), (14, 478, 464))
#: full-width mamba2-2.7b SSD geometry (phase 4's): heads, head_dim, state
#: size, groups, chunk
SSM_HEADS, SSM_HEAD_DIM, SSM_STATE, SSM_GROUPS, SSM_CHUNK = 80, 64, 128, 1, 256
#: phase 5: BERTScore's default max_len and the hash embedder's width, the
#: seven metrics (name, type), and the statistics API's sample size
BERT_LEN, BERT_DIM = 64, 256
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
    out = []
    for sq, sk, off in FLASH_SHAPES:
        def rnd(s, h):
            return torch.randn((1, s, h, HEAD_DIM), generator=g, device="cuda",
                               dtype=torch.float32).to(torch.bfloat16)

        q, k, v = rnd(sq, HEADS), rnd(sk, KV_HEADS), rnd(sk, KV_HEADS)
        got = flash_attention(q, k, v, q_offset=off)
        ref = flash_attention_ref(q, k, v, q_offset=off)
        torch.cuda.synchronize()
        # P is rounded to bf16 unnormalised in the kernel and normalised in
        # the plain version, and both round the output to bf16: 2^-7 of the
        # value plus 1% of the row's largest output.  A 32-key tile dropped
        # from a 2,048-key row moves the output by ~10x that allowance.
        err, ratio = rowwise(torch, got, ref, 2**-7, 1e-2)
        shape = (f"B=1 H={HEADS} K={KV_HEADS} d={HEAD_DIM} Sq={sq} Sk={sk} "
                 f"q_offset={off}")
        require(ratio <= 1.0, f"flash_attention {shape}: error/allowance {ratio:.3g}")
        pairs = sum(min(sk, off + i + 1) for i in range(sq))
        nbytes = 2 * HEAD_DIM * (2 * sq * HEADS + 2 * sk * KV_HEADS)
        b_ms, b_by = bound(4 * HEAD_DIM * pairs * HEADS, PEAK_BF16, nbytes)
        kx, vx = (t.repeat_interleave(HEADS // KV_HEADS, dim=2) for t in (k, v))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, kx, vx))
        mask = (torch.arange(sq, device="cuda")[:, None] + off
                >= torch.arange(sk, device="cuda")[None, :])
        sdpa = torch.nn.functional.scaled_dot_product_attention
        out.append({
            "name": "flash_attention",
            "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/flash_attention.py:93",
            "shape": shape,
            "max_abs_err": err,
            "ms": time_ms(torch, lambda: flash_attention(q, k, v, q_offset=off)),
            "device_ms": device_profile(
                torch, lambda: flash_attention(q, k, v, q_offset=off), 1),
            "plain_ms": time_ms(
                torch, lambda: flash_attention_ref(q, k, v, q_offset=off), iters=5),
            "library_ms": time_ms(torch, lambda: sdpa(qt, kt, vt, attn_mask=mask)),
            "bound_ms": b_ms,
            "bound_by": b_by,
        })
        causal = ""
        if sq == sk:
            causal_ms = time_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True))
            causal = f", sdpa is_causal (no mask tensor) {causal_ms:.4g} ms"
        log(f"flash_attention {shape}: err {err:.3g} (ratio {ratio:.3g}) "
            f"{out[-1]['ms']:.4g} ms (device {out[-1]['device_ms']:.4g} ms), plain "
            f"{out[-1]['plain_ms']:.4g} ms, sdpa {out[-1]['library_ms']:.4g} ms"
            f"{causal}, bound {b_ms:.4g} ms ({b_by})")

    # a row's bits do not depend on its tile, on Sq or on q_offset: the last
    # rows of phase 3's full prefill against the suffix prefill after a hit
    q, k, v = rnd(fs.prompt_len, HEADS), rnd(fs.prompt_len, KV_HEADS), \
        rnd(fs.prompt_len, KV_HEADS)
    full = flash_attention(q, k, v)
    tail = flash_attention(q[:, fs.shared:], k, v, q_offset=fs.shared)
    torch.cuda.synchronize()
    require(bool(torch.equal(full[:, fs.shared:], tail)),
            f"flash_attention: the last {fs.prompt_len - fs.shared} rows of a "
            f"{fs.prompt_len}-token prefill differ from the suffix prefill")
    log(f"flash_attention: rows {fs.shared}..{fs.prompt_len - 1} bit-equal between "
        f"the full {fs.prompt_len}-token prefill and the suffix prefill "
        f"(q_offset {fs.shared})")

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
                   2: "flash_attention, 2 consumer warpgroups"})
    return out


def decode_cases(torch) -> list[dict]:
    """Kernel 2 over phase 2's cache (16 slots of 1,024 f32 rows) at ragged
    lengths 1..1,024 and at the main path's: a 10-13-token prompt plus up
    to 32 new tokens, 11..45."""
    g = torch.Generator(device="cuda").manual_seed(1)
    ragged = torch.randint(2, MAX_LEN, (N_SLOTS,), generator=g, device="cuda",
                           dtype=torch.int32)
    ragged[0], ragged[1] = 1, MAX_LEN
    lo, hi = PROMPT_LEN - 1, PROMPT_LEN + 1 + MAX_TOKENS
    main = (lo + (hi - lo) * torch.arange(N_SLOTS, device="cuda") // (N_SLOTS - 1))
    out = [decode_case(torch, g, ragged, f"lengths 1..{MAX_LEN}"),
           decode_case(torch, g, main.to(torch.int32),
                       f"main-path lengths {lo}..{hi} (phase 2)")]
    # kernels 2 and 3 are one span-split template, four instantiations
    kernel_limits("repro_decode_kernel_info",
                  {0: "decode_attention split, G <= 4",
                   1: "decode_attention split, G <= 8",
                   2: "paged_decode_attention split, G <= 4",
                   3: "paged_decode_attention split, G <= 8"})
    return out


def device_profile(torch, fn, kernels: int, calls: int = 10,
                   tries: int = 3) -> float:
    """Device time (ms) of one call of ``fn``, every kernel it launches
    summed, from a ``torch.profiler`` trace of ``calls`` calls: the kernels
    alone, without the host time that CUDA events around a loop of short
    calls also measure.  ``kernels`` is the device kernels one call
    launches.  A trace that holds another count is taken again, up to
    ``tries`` times, and then fails: the profiler has dropped a kernel's
    record, which reads the call short."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if len(spans) == kernels * calls:
            return sum(spans) / 1e3 / calls
        counts.append(len(spans))
    raise CheckFailed(f"device profile: {counts} device records in {tries} traces "
                      f"of {calls} calls, not {kernels * calls} each")


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


def decode_case(torch, g, lens, label: str) -> dict:
    from repro_torch.kernels.decode_attention import (
        decode_attention,
        decode_attention_ref,
    )

    b, s = N_SLOTS, MAX_LEN
    q = torch.randn((b, 1, HEADS, HEAD_DIM), generator=g, device="cuda").to(
        torch.bfloat16)
    kc = torch.randn((b, s, KV_HEADS, HEAD_DIM), generator=g, device="cuda")
    vc = torch.randn((b, s, KV_HEADS, HEAD_DIM), generator=g, device="cuda")
    got = decode_attention(q, kc, vc, lens)
    ref = decode_attention_ref(q, kc, vc, lens)
    torch.cuda.synchronize()
    # both sides are f32 until the final bf16 rounding of the output
    err, ratio = rowwise(torch, got, ref, 2**-7, 1e-3)
    shape = (f"B={b} H={HEADS} K={KV_HEADS} d={HEAD_DIM} S={s} f32 cache, "
             f"{label}")
    require(ratio <= 1.0, f"decode_attention {shape}: error/allowance {ratio:.3g}")
    n_rows = int(lens.sum())
    nbytes = 2 * b * HEADS * HEAD_DIM * 2 + n_rows * KV_HEADS * HEAD_DIM * 4 * 2 + 4 * b
    b_ms, b_by = bound(4 * HEAD_DIM * n_rows * HEADS, PEAK_BF16, nbytes)
    qt = q.float().transpose(1, 2)
    kt, vt = (t.transpose(1, 2).repeat_interleave(HEADS // KV_HEADS, dim=1)
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



def paged_pool(torch, g, b: int, n_p: int, n_shared: int):
    """Phase 3's pool: b * n_p + b pages (the batcher's default) and the
    trash page, f32 (P, ps, K, d); tables whose first n_shared entries
    alias pages 0 .. n_shared - 1 in every sequence and whose other entries
    are shuffled private pages."""
    n_pool = b * n_p + b + 1
    shape = (n_pool, PAGE_SIZE, KV_HEADS, HEAD_DIM)
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


def paged_bound(torch, tables, lens, row_bytes: int, page_bytes: int,
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
              + 2 * b * HEADS * HEAD_DIM * 2 + 4 * (b * n_p + b) + extra_bytes)
    log(f"  bound inputs: {int(lens.sum())} visible keys, {n_rows} distinct "
        f"pool rows in {n_pages} pages, {nbytes} bytes")
    return bound(4 * HEAD_DIM * HEADS * int(lens.sum()), PEAK_BF16, nbytes)


def paged_cases(torch, fs) -> list[dict]:
    """Kernels 3 and 4 at phase 3's geometry (16 sequences, 64 pages of 16
    rows, a pool of 1,041 pages, the shared header's pages aliased in every
    table), at ragged lengths 1 .. 1,024 and at the main path's lengths."""
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
    k, v, full_tables = paged_pool(torch, g, b, n_p, n_shared)
    kq, ks = quantize_pages(k)
    vq, vs = quantize_pages(v)
    q = torch.randn((b, 1, HEADS, HEAD_DIM), generator=g, device="cuda").to(
        torch.bfloat16)
    k_new = torch.randn((b, KV_HEADS, HEAD_DIM), generator=g, device="cuda")
    v_new = torch.randn((b, KV_HEADS, HEAD_DIM), generator=g, device="cuda")
    ragged = torch.randint(1, MAX_LEN + 1, (b,), generator=g, device="cuda")
    ragged[:6] = torch.tensor([1, MAX_LEN, PAGE_SIZE, fs.shared, 512, 17])
    main = fs.prompt_len + 1 + 2 * torch.arange(b, device="cuda")
    out = []
    for label, lens in (("ragged lengths 1..1024", ragged),
                        (f"main-path lengths {int(main[0])}..{int(main[-1])}", main)):
        lens = lens.to(torch.int32)
        tables = pad_tables(torch, full_tables, lens)
        shape = (f"B={b} H={HEADS} K={KV_HEADS} d={HEAD_DIM} ps={PAGE_SIZE} "
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
        b_ms, b_by = paged_bound(torch, tables, lens, 2 * KV_HEADS * HEAD_DIM * 4, 0,
                                 False, 0)
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
        kt, vt = (t.transpose(1, 2).repeat_interleave(HEADS // KV_HEADS, dim=1)
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
        b_ms, b_by = paged_bound(torch, tables, lens, 2 * KV_HEADS * HEAD_DIM,
                                 2 * 4 * KV_HEADS, True,
                                 2 * b * KV_HEADS * HEAD_DIM * 4 + 4 * b)
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
    kernel_limits("repro_quant_paged_kernel_info",
                  {0: "quant_paged_decode_attention split, G <= 4",
                   1: "quant_paged_decode_attention split, G <= 8",
                   2: "quant_paged_decode_attention combine"})
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


def ssd_work(slen: int, chunk: int) -> tuple[int, int]:
    """FLOPs and bytes of one full-width SSD scan of one sequence in the
    chunked form.  FLOPs per
    head and chunk of ``q`` rows: the causal half of the intra-chunk
    products (C B^T over N, then S x over P), q(q+1)/2 (N + P)
    multiply-adds, and the chunk-state and off-diagonal products, 2 q P N;
    a ragged last chunk counts its own rows only.  Bytes: x, dt, B and C
    per group, y, the final state and ``a``, each once."""
    h, p, n, g = SSM_HEADS, SSM_HEAD_DIM, SSM_STATE, SSM_GROUPS
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
    chunks); x, B and C are column views of one fused xBC row, as the model
    slices them."""
    from repro_torch.kernels.ssd import ssd
    from repro_torch.models.ssm import ssd_chunked

    h, p, n, g = SSM_HEADS, SSM_HEAD_DIM, SSM_STATE, SSM_GROUPS
    out = []
    for slen in (12, fs.prompt_len, 2048):
        gen = torch.Generator(device="cuda").manual_seed(10 + slen)
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
        flops, nbytes = ssd_work(slen, SSM_CHUNK)
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
                   2: "ssd outputs"})
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
    default chunk) and 16,384.  Random embeddings stand in for the hash
    vectors; each example keeps a random prefix of its tokens, and
    examples 0-3 are the edges: an empty candidate, an empty reference,
    both empty, and one pair at cosine -0.995 (F1 ~ 2e9)."""
    from repro_torch.kernels.bertscore import bertscore, bertscore_pr, bertscore_ref
    from repro_torch.kernels.bertscore.ref import f1_from_pr

    lc = lr = BERT_LEN
    d = BERT_DIM
    out = []
    for b in (CHUNK, 1024, 16384):
        g = torch.Generator(device="cuda").manual_seed(20 + b)
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
        shape = (f"B={b} Lc={lc} Lr={lr} D={d}, random prefix masks, 4 edge rows "
                 f"(max_abs_err leaves out the -1e30 sentinel rows)")
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
    return [
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


def timed_run_task(torch, session, task, kernels: tuple[str, ...], label: str,
                   check_metric=unit_range):
    """``run_task`` over the phase's rows with every launch count set to 0
    just before and read just after; each of ``kernels`` must have
    launched, and every metric pass ``check_metric(name, value)``.
    Returns (launches, serving stats, wall seconds, result)."""
    from repro_torch.data import iter_qa_examples

    engine = session.engine_for(task.model, task.inference)
    # an engine that served before (phase 5 reuses phase 2's) counts on
    # from there: the serving numbers below are this run's differences
    before = engine.serving_stats()
    for fn in counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    result = session.run_task(iter_qa_examples(N_ROWS, seed=0), task)
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
    log(f"{label}: run_task wall {wall:.3f} s for {N_ROWS} examples; "
        f"{run['admissions']} prefills, {prefill_ms:.2f} ms each; "
        f"{run['steps']} decode steps, {step_ms:.2f} ms each (batch {N_SLOTS}); "
        f"{run['tokens_generated']} decoded tokens, "
        f"{run['tokens_generated'] / run['decode_s']:.1f} tokens/s in decode, "
        f"{generated / wall:.1f} generated tokens/s end to end")
    if task.streaming.enabled:
        require(result.logs["streaming"]["n_examples"] == N_ROWS, "examples lost")
    else:
        require(len(result.responses) == N_ROWS
                and all(v.shape == (N_ROWS,) for v in result.scores.values()),
                "in memory: responses or per-example scores lost")
    for name, mv in result.metrics.items():
        log(f"{label} metric {name}: {mv} ({mv.ci_method})")
        require(mv.n == N_ROWS, f"{name}: scored {mv.n} of {N_ROWS}")
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
    """Phase 5: ``run_task`` over the 64 QA rows with the seven metrics and
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


def main_path_phase(torch) -> tuple[dict[str, int], dict[str, int]]:
    from repro_torch.core import EvalSession, InferenceRequest
    from repro_torch.data import iter_qa_examples, render

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

        # greedy tokens must not depend on the batch around a prompt
        rows = list(iter_qa_examples(N_SLOTS, seed=0))
        reqs = [InferenceRequest(render(task.data.prompt_template, r), MAX_TOKENS)
                for r in rows]
        full = engine.infer_batch(reqs)
        alone = engine.infer_batch(reqs[:1])
        require(full[0].text == alone[0].text
                and full[0].output_tokens == alone[0].output_tokens,
                f"batch-dependent tokens: {full[0].text!r} vs {alone[0].text!r}")
        log(f"batch invariance: prompt 0 gives {alone[0].output_tokens} identical "
            f"tokens alone and among {N_SLOTS} slots")

        # the logits themselves: one prefill and one decode step on slot 0
        b = engine.batcher
        toks = torch.tensor([[2, 5, 7, 11]], device="cuda")
        logits = b.model.prefill(b.params, toks, b.cache, 0)
        nxt = logits.argmax(-1).repeat(N_SLOTS)[:, None]
        pos = torch.full((N_SLOTS,), 4, device="cuda")
        step = b.model.decode_step(b.params, nxt, b.cache, pos)
        require(bool(torch.isfinite(logits).all() and torch.isfinite(step).all()),
                "logits hold NaN or inf")
        step_breakdown(
            torch, f"decode step (batch {N_SLOTS}, all slots at position 4)",
            lambda: b.model.decode_step(b.params, nxt, b.cache, pos),
            kernel=DEVICE_KERNEL["decode_attention"])
        # where a prefill's time goes: a main-path prompt, and a prompt of
        # phase 3's length prefilled in full
        for n_tok in (PROMPT_LEN, 478):
            toks = torch.arange(2, 2 + n_tok, device="cuda")[None, :]
            step_breakdown(torch, f"prefill ({n_tok} tokens into slot 0)",
                           lambda: b.model.prefill(b.params, toks, b.cache, 0),
                           kernel="flash")
        metrics = metrics_phase(torch, session, task)
    return launches, metrics


#: a part of the device kernel names behind each decode wrapper, for the
#: step breakdowns (kernels 2 and 3 are one template, split_decode.cuh)
DEVICE_KERNEL = {"decode_attention": "split_kernel<false",
                 "paged_decode_attention": "split_kernel<true",
                 "quant_paged_decode_attention": "quant_"}


def step_breakdown(torch, label: str, run, steps: int = 5,
                   kernel: str | None = None) -> None:
    """Where a step's time goes: host-clock wall per call of ``run``
    without the profiler, then device time per call by kernel from a
    ``torch.profiler`` trace of further calls (and the share of the
    kernels whose name holds ``kernel``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
    by_name: dict[str, list[float]] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    if not by_name:
        log(f"{label}: breakdown not measured (the profiler saw no device time)")
        return
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
                   for r in iter_qa_examples(N_ROWS, seed=0)]
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

        def flash(q, k, v, *, q_offset=0):
            self.suffix_prefills += q_offset > 0
            return self._flash(q, k, v, q_offset=q_offset)

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


def paged_run(torch, params, fs, label, kernel, **inference):
    """One paged ``run_task`` over the few-shot task with the given
    paging knobs; returns (launches, serving stats, tokens by request)."""
    from repro_torch.core import EvalSession

    task = make_task(fs.template, kv_page_size=PAGE_SIZE, **inference)
    engine_kwargs = {"n_slots": N_SLOTS, "max_len": MAX_LEN, "params": params}
    tokens: dict[int, list[int]] = {}
    with EvalSession(device="cuda", engine_kwargs=engine_kwargs) as session:
        engine = session.engine_for(task.model, task.inference)
        respond = engine._response

        def keep_tokens(c):
            tokens[c.request_id] = c.tokens
            return respond(c)

        engine._response = keep_tokens
        with Probe() as probe:
            launches, st, _, _ = timed_run_task(
                torch, session, task,
                ("flash_attention", kernel, "bootstrap_partials"), label)
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
    free_cuda(torch)
    return launches, st, tokens


def infer_gates(torch, params, fs) -> None:
    """Through ``infer_batch`` on 16 few-shot prompts: the paged engine
    without sharing gives the contiguous engine's texts, and so does the
    same engine with a pool so small that decode preempts."""
    from repro_torch.core import EngineModelConfig, InferenceRequest, TorchLocalEngine
    from repro_torch.data import iter_qa_examples, render

    model = EngineModelConfig(provider="torch_local", model_name="qwen3-4b",
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
    need = -(-fs.prompt_len // PAGE_SIZE)
    tight, st, _ = serve(f"paged engine, no sharing, pool of {2 * need + 1} pages",
                         kv_page_size=PAGE_SIZE, prefix_cache=False,
                         page_pool=2 * need + 1)
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
    f32, _, tok_f32 = paged_run(torch, params, fs, "paged f32 path",
                                "paged_decode_attention", prefix_cache=True)
    int8, _, tok_int8 = paged_run(torch, params, fs, "paged int8 path",
                                  "quant_paged_decode_attention",
                                  kv_cache_dtype="int8")
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
    b.cache.conv[:, 0].zero_()
    b.cache.state[:, 0].zero_()
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
    seed 0) over phase 3's 64 few-shot prompts in chunks of 16, 16 slots,
    32 new tokens; then the gates: one prefill of each prompt and 64 SSD
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
                torch, session, task, ("ssd", "bootstrap_partials"), "mamba2 path")
        require(st["admissions"] == N_ROWS, f"{st['admissions']} prefills")
        require(launches["ssd"] == cfg.n_layers * N_ROWS,
                f"ssd launched {launches['ssd']} times, not "
                f"{cfg.n_layers} x {N_ROWS}")
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


def suite_phase(torch) -> dict[str, int]:
    """Phase 6: one session holding full-width qwen3-4b and mamba2-2.7b
    (random bf16 weights from seed 0) on the card; ``run_suite`` over both
    models x an in-memory task and a streaming task (chunks of 16,
    ``backend="device"``, percentile) with two lexical metrics and the
    cosine metric; the same suite with ``parallel_jobs=2`` against the
    serial run; the response cache (a second run with no engine call, then
    ``CacheMiss`` under ``REPLAY``); ``rescore_stages`` with BERTScore; and
    single-flight over repeated prompts.  Returns the phase's launches."""
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
    from repro_torch.data import iter_qa_examples

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
            f"coalesced {s['coalesced']}" for s in serving))
        log(f"phase 6 accounting: {session.accounting.as_dict()}")

    phase_launches = read_counts()
    log(f"phase 6 launches: {phase_launches}; "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB peak allocated")
    for name in SUITE_KERNELS:
        require(phase_launches[name] > 0, f"phase 6: {name} was not launched")
    log(f"phase 6 took {time.perf_counter() - t_phase:.1f} s")
    return phase_launches


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
        contiguous, metrics = timed("phases 2 and 5", main_path_phase, torch)
        paged = timed("phase 3", paged_phase, torch, fs)
        mamba = timed("phase 4", mamba_phase, torch, fs)
        suite_phase(torch)
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
    for e in entries:
        e["launches"] = launches[e["name"]]
    for e in entries:
        for key in ("ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err"):
            if e[key] is not None and not math.isfinite(e[key]):
                print(f"chip_smoke: FAIL: {e['name']} {key} = {e[key]}",
                      file=sys.stderr)
                return 1
    log(f"phases 1-6 took {time.perf_counter() - t_start:.1f} s after the build")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
