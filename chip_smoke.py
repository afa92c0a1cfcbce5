#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py                  # every phase, one card
    python3 chip_smoke.py --only kernels   # device, build and kernel phases
    python3 chip_smoke.py --only longctx   # device, build, long-context profiles
    python3 chip_smoke.py --only int4      # device, build, E's route, the int4 engine
    python3 chip_smoke.py --only retrieval # device, the retrieval path
    python3 chip_smoke.py --only rag       # device, build, the question-answering loop
    python3 chip_smoke.py --only ingest    # device, build, the ingest pipeline
    python3 chip_smoke.py --only options   # device, build, the engine options in pairs
    python3 chip_smoke.py --only split     # device, build, the rag phase, the split deployment
    python3 chip_smoke.py --only modes     # device, build, A's verify window, the engine modes
    python3 chip_smoke.py --only draft     # device, build, A at the draft's shapes, draft speculation
    python3 chip_smoke.py --only fleet     # device, build, the fleet (router, disagg, controller)
    python3 chip_smoke.py --only moe       # device, build, the Qwen2-MoE family (A2.7B)
    python3 chip_smoke.py --only train     # device, training (Qwen2-0.5B, float32)
    python3 chip_smoke.py --only mesh      # device, build, serving over a mesh (one rank)

Phases, each raising on failure:

1. device  -- the card's name and power limit (nvidia-smi), torch and CUDA.
2. build   -- compile every kernel in githubrepostorag_tpu_torch/csrc with
              nvcc (one process per source, all at once).
3. kernels -- hold each kernel (and each pool branch of A and B) against
              its plain PyTorch version, element by element, at the shapes
              the serving path gives it, in float32 and bf16 (kernel F also
              against kernel A at S = 1, with table entries past each row's
              pages set to -1 and a row with no key); time in bf16
              the kernel, the plain version, and PyTorch calls computing
              the same function (scaled_dot_product_attention over
              pre-gathered, dequantized K/V for A, B, C and F; for the int4
              GEMMs D and E, torch.matmul against the dequantized bf16
              weight and torch._weight_int4pack_mm where the card's torch
              has it): yardsticks the port never calls; compute the least
              time the card could take for the same work.  Kernel D also
              at ragged shapes through both of its loaders (TMA and
              cp.async, each launch counted by loader), at every tile of x
              rows its plan could take, and bit for bit against dequant4
              through an identity x.  Kernels B and F (split-K over pages)
              also at batch 1 over 8192 keys, at rows ending on and one past
              a split edge of the wrapper's plan, one key and none (B: the
              staged tail alone), 8-key pages at hd 64, fp and int8; timed
              by device time (torch.profiler, per kernel) and by CUDA
              events, and at every other pages-per-split (each held to the
              plain version).  Kernel E (the whole W4A8 route: prologue and
              tensor-core kernel) at every 7B decode shape for M = 1, 8,
              64 and 256 (timed at 8 and 64: device time of both kernels,
              with and without programmatic dependent launch, host time a
              call), at groups 128 and 256, ragged N, 77 rows and groups
              48 and 16 (its CUDA-core kernel), its prologue's codes, sxn
              and R bit for bit against quantize_rows on every case and on
              .5 ties and an all-zero row; and the route on the card:
              groups 64/128/256 take E, 32/48 D.
              Kernels A and C (bf16: the tensor-core body; f32: the
              CUDA-core one) also at their tile edges (group 7's flat rows
              across 128-row tiles, a row with no key, 8-key pages at hd
              64, int4 there), and A at the long-context profile's launch
              (B=8, S=128 over 7936 keys; bf16 and int8 pages); A and C are
              timed by device time, with the wrapper's host time per call.
              Kernel A also at the width ladder's S = 256 (B=4, contexts to
              3,300; f32 and bf16, fp and int8 pages, timed in bf16), and
              its rows at S = 128 and 256 bit for bit equal to S = 512;
              and which 7B bf16 projections give a row other bits when the
              GEMM has fewer rows (cuBLAS's choice): none may from 512 rows
              on, the engine's prefill row floor.
   dispatcher -- kernel F's path: paged_attention at S = 1 launches F once
              and nothing else; at S = 512 it launches nothing and equals
              paged_attention_ref.
   retrieval -- the retrieval path (no kernel of A-F may launch in it):
              the e5-small BERT encoder at its published widths, random
              float32 weights from the seed, text tokenised by a stdlib
              stand-in: embed on the card (allow_tf32 on around it) against
              the plain path on the CPU in float64 at every length bucket,
              padded rows leaving real rows unchanged, warmup's shape
              ladder covering encode, passages/s over 8192 code-like
              chunks at batch 64, single-query latency; the device index
              over 258,048 chunks (capacity 262,144 x 384 in float32)
              against the host store (a 16-query wave with and without
              filters, a block of duplicated vectors in insertion order,
              the k > k_bucket fallback), wave latency (wall and device
              time); 16 threads through RetrieverFactory's coalescer equal
              to the direct path; a live-index churn through MutationLog
              and LiveIndexApplier while queries run (every result a prefix
              of the stream, compaction in place, no whole-table put, no
              new shape); a snapshot saved and restored into a fresh index,
              identical in scores and tie order.
   load    -- a full-width Qwen2-7B checkpoint cut to 2 layers, written
              with the port's safetensors writer and loaded onto the card
              by load_qwen2: tensors and prefill logits bit for bit equal
              to the in-memory tree's; loaded again with quantize=4
              (kernel D).
4. model   -- Qwen2-7B at its published widths and depth, random bf16
              weights from a seeded generator on the card: forward_paged
              and forward_paged_packed prefill logits with the kernels
              against the plain path, and forward_paged over int8 / int4
              KV pages against full-precision pages.
5. engine  -- AsyncEngine(Engine(...)) at 7B serves a few requests
              (chunked prefill, a prefix-cache hit, one sampled row) after
              every kernel's launch count is set to 0; afterwards each
              kernel (or pool branch) of the path must have launched, and
              kernels the path never reaches must not have.  Four runs:
              bf16 pages; packed prefill (prefill_token_budget=2048);
              int8 pages; int4 pages with packed prefill.  Right after the
              bf16 run the same traffic again with prefill_widths=3 and
              prefill_priority: every greedy row's tokens identical to the
              bf16 run's, kernel A launched at windows 512, 256 and 128
              (both runs then serve one more request, resuming 100 tokens
              past the cached prefix, outside the traffic's numbers).
   longctx -- after the four runs: long-context decode (8 rows of distinct
              7936-token prompts, 17 greedy tokens, an engine of its own
              with 520 pages) profiled as above, bf16 and int8 pages:
              kernels B's and A's totals and launches, idle share, TPOT,
              prefill tokens per call.
   http    -- right after the bf16 run: the same 7B tree served over HTTP
              on localhost through the model server's entry points
              (settings from the environment, build_engine, AsyncEngine,
              OpenAIServer, byte tokenizer); stdlib clients send every
              route, a malformed body and a wave of 8 concurrent streamed
              chats; A and B must launch, nothing else; no page leaks;
              GET /debug/index without and with a live-index applier.
   rag     -- after the http phase: the question-answering loop through
              the RAG service's entry points: the engine built by
              api/__main__ (inprocess_llm over build_engine, the engine
              phase's geometry, QWEN_MAX_OUTPUT=64, the byte tokenizer),
              GraphAgent over the retrieval phase's device index plus repo,
              module, file and catalog docs, RagApi + RagWorker over the
              memory bus on localhost; 8 jobs posted at once (code and repo
              questions, one whole-repo architecture question in the
              long-context mode, one cancelled at its first turn, one whose
              deadline_ms the engine reaps), every SSE stream read to
              final, each finished job's trace (agent stages, llm.generate
              over engine.prefill / engine.decode), /health, /metrics;
              A and B must launch, nothing else; no page leaks; every index
              search on the device.  ``--only rag`` builds the index at the
              same size first.
   split   -- right after the rag phase, on its engine: the split
              deployment over stand-ins on localhost (tests/miniredis.py,
              tests/torch_minicassandra.py: Python servers, in a process
              of their own, with the prefix cache emptied first): the rag
              phase's scope docs and one repository's chunk rows written
              through the port's CassandraVectorStore (rows/s), a device
              index seeded from it (seconds); the API pod
              (api --redis --no-worker, a subprocess; no card memory);
              worker (a), RagWorker in this process over RedisBus /
              RedisCancelFlags / RedisJobQueue and that index: the rag
              phase's eight jobs through the API pod, terminal states
              equal to the rag phase's, the cancel through the Redis
              flag, every result read back, the frames each stream
              missed counted (pub/sub has no replay); A and B must
              launch, nothing else; no page leaks; every search on the
              device.  Worker (b), python -m githubrepostorag_tpu_torch.
              worker over a full-width 2-layer checkpoint with
              STORE_BACKEND=cassandra and DEVICE_INDEX=on: start to ready,
              two jobs, /metrics, exit 0 on SIGTERM, then MiniRedis.stop()
              within 5 s.  Then the native store (built into _build/) over
              the chunk rows against the memory store.  Prints
              {"split": ...}; ``--only split`` builds the rag index first.
   ingest  -- after the split phase: a seeded synthetic repository (three
              modules and a root README, Python, JavaScript, Markdown, a
              notebook, a skipped image) ingested through
              ingest.__main__.main (--local) with the rag phase's engine
              behind set_llm, the retrieval phase's encoder, the memory
              store in the device index, DATA_DIR / STORE_PATH in a temp
              dir: every scope written with the counts the tree implies,
              the LLM prompts the tree implies (each one engine request),
              no extractor stage on its exception path, device rows equal
              to host rows, 8 queries ranked alike by index and host store,
              the run record and .ingest_complete, the saved store reloaded
              with the same counts; A and B must launch, nothing else; no
              page held.  Then one code question through RagApi + RagWorker
              over the ingested store reaches final with sources from the
              tree.  Then the vector write at one repository's size (2048
              enriched chunk nodes into a fresh device-indexed store, the
              encoder alone beside it).  Prints {"ingest": ...}.
   options -- ``--only options`` alone (measurement): the long-context
              bf16 profile with prefill_widths 1 / 3 / 3 / 1, small waves'
              TTFT and device time with prefill_widths 1, 3, and 3 without
              the row floor, and the rag phase's jobs with
              PREFILL_PRIORITY off / on / on / off.
   modes   -- after the long-context profiles: the engine's speculative and
              host-tier modes at Qwen2-7B (random bf16 weights, 256 pages
              of 128, 8 rows, chunk 512), each engine built by the model
              server's build_engine from its settings and warmed up: the
              modes traffic (5 RAG-quoting prompts of 512-2048 tokens x 32
              tokens, then a decode wave of 8 x 64) through AsyncEngine with
              the default engine, SPEC_NGRAM_K=4, +SPEC_BURST_ITERS=4,
              +FUSED_STEP=1 with PREFILL_TOKEN_BUDGET=2048, the fused step
              again with two sampled rows (temperature 0.8, top-p 0.9) over
              bf16 and over int4 pages, and the int4 pages' gather path:
              launches pinned (A at S = 5 in every spec run, C in the fused
              bf16 runs, never B in a spec run), TPOT, decode tok/s, tokens
              per main-model dispatch, proposed / accepted, a profiled
              decode window (A's total, idle share); greedy rows against the
              default run's, any divergence a near tie (the teacher-forced
              logits of the two tokens within 2 D, D the run's own gap
              between S = 1 and S = 5 logits of the same positions); float32
              identity at 2 layers (default, spec, burst, fused: every token
              equal); one spec burst and one fused step under
              torch.cuda.set_sync_debug_mode("error"); the host tier (48
              device pages, 256 host pages, four 2048-token prefixes, the
              first faulted back in: same tokens, byte-equal pages;
              migration and fault-in ms per page and GB/s beside a plain
              pinned copy); preempt-to-host (two rows, 20 pages: one park,
              one resume, no prompt token recomputed, no leak; the
              interactive TTFT with PREEMPT off and on).  Kernel A is also
              held at the verify window in the kernel phase (B=8, S=5, new
              0-5, contexts to 2048, fp / int8 / int4 pages).  Prints
              {"modes": ...}.
   draft   -- after the modes phase: draft-model speculation at Qwen2-7B
              with a draft at Qwen2-0.5B's widths and depth (hidden 896, 24
              layers, 14/2 heads, hd 64, intermediate 4864) and the 7B's
              vocabulary (152,064: the reference refuses the published
              0.5B's 151,936 beside the 7B's), each draft written as a
              checkpoint into a temp dir under _build/ and loaded by the
              model server's build_engine through SPEC_DRAFT_MODEL (SPEC_K
              4, SPEC_ITERS 4): the modes traffic with the default engine,
              a random draft over the random target (the acceptance floor
              demotes the rows: B launches), the same with the floor at 0
              (every token through a verify window), the quoting pair (the
              modes phase's quoting target, a quoting draft), a partly
              quoting draft (t -> t+2 where t % 8 == 0: partial acceptance,
              the k ladder's rungs counted), the quoting pair over int8
              target pages (draft pools bf16): TPOT, decode tok/s, tokens
              per main-model dispatch, proposed / accepted, fallbacks by
              reason, a profiled decode window's idle share, A's launches
              at hd 64 and hd 128 pinned, the compile watchdog 0 after
              warmup in every run, the obs hooks' us a step; bf16
              divergences only at near ties; float32 identity at 2 layers
              (floor 0); the host tier with the draft on (draft = target:
              both pools' faulted-in pages byte-equal, acceptance equal to
              the first serve's); one draft burst under
              torch.cuda.set_sync_debug_mode("error").  Kernel A is held at
              the draft's shapes in the kernel phase (S = 1 at 14/2 heads
              hd 64, the draft's S = 512 prefill, the verify rungs S = 2
              and 3 at 28/4 hd 128).  The rag phase also reads /debug/slo,
              /debug/hbm, /debug/timeline and /debug/fleet from the RAG API
              (held to tests/golden/), the watchdog, the ledger (committed
              tokens equal the jobs' tokens; buckets, limiter, stall p50,
              goodput, MFU at 989 TFLOP/s), the page observatory
              (attribution within 1 % of its occupancy integral) and the
              obs hooks' cost.  Prints {"draft": ...}.
   fleet   -- after the draft phase: the fleet at Qwen2-7B's widths (random
              bf16 weights, the engine phase's geometry; 7 of its 28
              layers in the whole script, 28 under ``--only fleet``), every replica built
              by the model server's build_serving_engine over the one
              weight tree, launching A and B (pinned, nothing else) on
              the card's default stream.  (a) Router: one engine, then
              MESH_SHAPE=dp:2, each behind the model server over HTTP; 16
              greedy completions (4 groups of 4 sharing a 1024-token
              prefix, 100-300 token tails, 32 tokens): a group's first
              request alone, its other three once it has a first token,
              the next group once all four have: affinity hits at least
              12 less the slack spills the router reports; TTFT p50 / p95,
              latency, decode tok/s, routed per replica; the fleet's tokens
              against the one engine's (bf16: near ties only); the decode
              wave (8 x 17, 256-token prompts) warm, timed and profiled
              through each: idle share under one and two driver threads
              (``--only fleet``: also the replicas' shared step lock
              against none in turns, on the wave and on the 16 requests
              again, shared / none / none / shared, on fresh prompts);
              memory of one engine and of two replicas; the watchdog 0 on
              every replica; float32 at 2 layers: every token of two
              groups equal.  (b) DISAGG=on, KV_TIER=on, two replicas:
              two groups handed off (pages shipped, export / import /
              fault-in ms a page and GB/s), the same again (deduped), the
              shipped pages byte-equal on both replicas, tokens against
              the one engine's; FAULTS=disagg.transfer:error on two new
              prompts: the transfer_error fallback.  (c) dp:3,
              FLEET_SPARES=1, CTRL=on over HTTP: 8 requests; once r0 has a
              token, FAULTS=fleet.step.r0:error@window=3: kills its driver:
              r0's requests answered with the fence's error, r2 activated,
              r0 retired, 4 more served; seconds from the kill to r2
              active and to the first request served after; failopen 0,
              the watchdog 0 across the activation, the failover on
              /debug/fleet, the fence on /debug/timeline.  Prints
              {"fleet": ...}.
   mesh    -- after the fleet phase, on the bf16 7B tree: serving over
              a tp / sp / ep mesh as one tp rank sees it.  (a) Each kernel
              at the shapes one rank of a tp group launches, against its
              plain version, timed with its bound and library time: A
              (B=4, S=512, contexts to 4096; fp and int8 pages) and B (B=8,
              pools to 8192, 8 staged; fp and int8) at 14/2 (tp 2) and 7/1
              (tp 4) heads, C at 7/1 (T=2048), E (M=8) and D (M=4096) on
              wgu at N = 37888/4 and wd at K = 18944/4, group 64.  (b) A
              one-rank NCCL world (localhost JAX_COORDINATOR_ADDRESS) and
              Engine(mesh=make_mesh(MeshPlan())) over the unfused tree,
              so every collective of the mesh path is issued: float32 at
              2 layers, greedy tokens equal the mesh-less engine's; bf16 at
              7 of 28 layers in the whole script (28 under --only mesh),
              TTFT and TPOT p50 beside the mesh-less engine's, A and B
              launching on the mesh run; the same traffic on the mesh
              with prefill_token_budget=2048 (C and B launch) and with
              int4 weights (D and E on the rank's slices).  (c) The ring prefill at sp = 1
              in that world, called directly (the engine routes the ring
              only at sp > 1): prompts of 3000 and 1000 tokens in one
              4096-token pass (ring_prefill_packed) and the 3000 alone
              (ring_prefill); float32 at 2 layers: first tokens equal the
              chunked path's (kernel A) and pages within 1e-5 of its
              pages; bf16: 32 decode tokens a row through kernel B over
              the ring-written pages, and the ring pass's ms beside
              chunked prefill's for the same tokens.  Prints {"mesh": ...}.
6. int4    -- the same 7B tree quantized to group-wise int4 (group 64) on
              the card, layer by layer; the model checks again (prefill
              logits through kernel D, decode logits through kernel E),
              then the engine phase again with the int4 weights (A, B, D
              and E must all launch, every D launch through TMA, every E
              launch through the tensor-core kernel; the profile reports
              E's total, its prologue's by name).  ``--only int4`` runs E's
              route times and this engine phase alone, also from another
              checkout of the port (copy this script there).
7. moe     -- with the int4 tree freed: the Qwen2-MoE family at
              Qwen1.5-MoE-A2.7B's published widths (60 experts top-4, a
              shared expert, 16 / 16 heads: GQA group 1).  Kernels A
              (B=4, S=512, contexts to 4096; fp, int8, int4 pools) and B
              (B=8, pools to 8192, 8 staged; fp, int8) at group 1 against
              their plain versions, bf16 timed against bound and SDPA;
              float32 at 2 layers: forward_paged logits and an engine's
              greedy tokens, kernels against the plain path; the A2.7B at
              24 layers, random bf16 weights drawn on the card, through
              the engine phase (capacity factor 2.0, MOE_DROP_STATS on for
              the traffic): TTFT, TPOT, tok/s, peak memory, the dropped
              share at prefill and at decode, the decode batch's device
              split (expert bmm, router, dispatch / combine, shared
              expert, dense projections, A, B, idle), A and B launches
              equal to the block's prefill and decode layer calls; a
              2-layer MoE checkpoint written, loaded and served over HTTP
              by the model server's build_serving_engine (one chat
              completion).  Prints {"moe": ...}.
8. train   -- with the MoE tree freed: the training path, which reaches
              none of the kernels (dense attention, or the ring over sp,
              and the AdamW update are torch ops).  At 2 layers of
              Qwen2-0.5B's widths in float32: one make_train_step step on
              the card against the same step on the CPU (IEEE float32 on
              both: loss, every gradient, the updated parameters), then
              the same step inside a one-rank NCCL world started by
              maybe_initialize_distributed from a localhost
              JAX_COORDINATOR_ADDRESS (every collective of the step over
              NCCL): its loss bit for bit the group-free step's.  Then
              Qwen2-0.5B at its widths and 24 layers, float32 parameters
              from the seed, remat on, one fixed batch of 8 x 512 tokens:
              2 warm-up and 10 timed steps (the loss finite and falling),
              step ms p50, tokens/s, peak memory, the step's share of the
              card's float32 peak, a traced step's device time (GEMMs, the
              largest kernels); the trained parameters saved with
              save_checkpoint and restored onto themselves bit for bit
              (seconds, GB/s).  Prints {"train": ...}.
9. summary -- whether transformers, prometheus_client, pydantic, psutil and
              requests import here, the retrieval, rag, engine-options,
              ingest, split, modes, draft, fleet, moe and train numbers, the card's
              name and power limit, the kernel list (A and B with their group-1 times and
              MoE-path launches), then the result line.

There is no CPU fallback: without a card the script exits non-zero.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import gc
import io
import json
import subprocess
import sys
import time

import numpy as np

# published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES_PER_S = 3.35e12
# kernel vs plain version, element-wise |out - ref| <= atol + rtol * |ref|,
# by output dtype.  Both accumulate in float32 and round the output once: in
# bf16 the two f32 results (summed in another order) round to the same value
# or to neighbours one bf16 ulp apart (at most 2**-7 of |ref|); atol covers
# elements near 0, where the f32 summation order itself shows.  In float32
# only the summation order differs.
KERNEL_TOL = {"torch.bfloat16": (1e-5, 2 ** -7), "torch.float32": (1e-5, 0.0)}
# The int4 GEMMs sum K = 3584..18944 products, and a fixed 1e-5 cannot
# describe how far two f32 summation orders of such a sum drift apart: the
# drift scales with the magnitudes summed.  Their element-wise limit is
# GEMM_ATOL * T + rtol * |ref|, with T[m, o] the sum over k of |x[m, k]| *
# |w[k, o]| (for W4A8, over the group terms it adds) and rtol as above.
# 2**-20 is 16 units of f32 roundoff of T; a wrong group scale or nibble
# moves an output by about 1e-2 * T.
GEMM_ATOL = 2 ** -20
GROUP = 64  # int4 group size (the JAX package's default)
# 7B logits in float32, kernels vs plain path: the same f32 arithmetic
# summed in another order, through 28 layers
LOGITS_RTOL_F32 = 1e-3
# 7B logits in bf16: the kernel path's error against the f32 plain logits
# may exceed the plain bf16 path's by at most this factor
LOGITS_BF16_SLACK = 1.25

SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_us(fn, iters: int = 20, tries: int = 5) -> dict:
    """Mean device time (us) per call of each kernel ``fn`` launches, by
    kernel name, from a torch.profiler trace of the card.  The trace can
    come back short (kernel records of whole calls missing, seen on this
    card's machine): a trace counts only if it holds records and every
    kernel name's launch count is a whole multiple of ``iters``; else it is
    taken again, up to ``tries`` times.  When every trace came back short
    (one whole-script run lost the same two calls' records in five traces
    of kernel C), a name's time a call is its mean time a record times its
    records a call, as ``call_device_us`` reads a trace; a trace with no
    record raises."""
    for attempt in range(tries):
        total, count = trace_calls(fn, iters)
        if total and all(c >= iters and c % iters == 0 for c in count.values()):
            return {k: t / iters for k, t in total.items()}
        log(f"device_us: trace {attempt + 1} of {tries} incomplete, launches {count}")
    if not total:
        raise RuntimeError(f"the profiler recorded no device activity in {tries} traces")
    log("device_us: every trace short; the time a call is the mean a record times the "
        "records a call")
    return {k: total[k] / count[k] * max(1, round(count[k] / iters)) for k in total}


def trace_calls(fn, iters: int) -> tuple[dict, dict]:
    """Device time (us) and record count by kernel name (copies and sets by
    their kind, "Memcpy HtoD (Pageable -> Device)", ...) over ``iters``
    calls of ``fn`` after one untraced call, from a torch.profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total, count = {}, {}
    for e in prof.key_averages():
        if "CUDA" in str(e.device_type) and e.self_device_time_total > 0:
            key = e.key.replace("(anonymous namespace)::", "")
            if not key.startswith(("Memcpy", "Memset")):
                key = key.split("<")[0].split("(")[0].split("::")[-1].split(" ")[-1]
            total[key] = total.get(key, 0.0) + e.self_device_time_total
            count[key] = count.get(key, 0) + e.count
    return total, count


def call_device_us(fn, iters: int = 20) -> dict:
    """Device time (us) of one call of ``fn`` by kernel name, and by kind
    for copies ("Memcpy HtoD (Pageable -> Device)", ...), from one
    torch.profiler trace of ``iters`` calls.  For calls that copy as well
    as launch: the trace drops a record now and then on this card's
    machine, and a pageable copy may come as several records, so a name's
    time a call is its mean time a record times its records a call,
    rounded (at least 1), not its total over ``iters``."""
    total, count = trace_calls(fn, iters)
    if not total:
        raise RuntimeError("the profiler recorded no device activity")
    return {k: total[k] / count[k] * max(1, round(count[k] / iters)) for k in total}


def agreement(out, ref) -> dict:
    """Max |out - ref| and the largest share of the element-wise limit any
    element uses (over 1 fails)."""
    atol, rtol = KERNEL_TOL[str(out.dtype)]
    diff = (out.float() - ref.float()).abs()
    share = diff / (atol + rtol * ref.float().abs())
    return {"max_abs_err": diff.max().item(), "limit_share": share.max().item()}


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


# ---------------------------------------------------------------- phases --


def phase_device() -> dict:
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    return {"card": card, "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase_build() -> None:
    from githubrepostorag_tpu_torch import kernels

    t0 = time.monotonic()
    seconds = kernels.build()
    log(f"build: {time.monotonic() - t0:.1f} s wall; per source {seconds}")
    for name, out in kernels.build_logs.items():
        for line in out.splitlines():
            if "Compiling entry function" in line:  # the mangled name of the next reports
                log(f"  ptxas[{name}] entry {line.split(chr(39))[1][:120]}")
            elif any(w in line.lower() for w in ("registers", "spill", "error", "warning", "c75")):
                log(f"  ptxas[{name}] {line.strip()}")


def _shuffled_tables(rng, lens, page_size, max_pages, spare=16):
    """Block tables over a pool with holes: rows own disjoint, shuffled
    pages of a pool larger than they need."""
    need = [-(-int(n) // page_size) for n in lens]
    num_pages = sum(need) + spare
    perm = rng.permutation(num_pages)
    bt = np.zeros((len(lens), max_pages), dtype=np.int32)
    at = 0
    for i, n in enumerate(need):
        bt[i, :n] = perm[at:at + n]
        at += n
    return bt, num_pages


def kernel_a_case(rng, dev, b, s, n_q, n_kv, hd, ps, cached, new, dtype=None):
    import torch

    dtype = dtype or torch.bfloat16

    total = [c + n for c, n in zip(cached, new)]
    max_pages = max(1, -(-max(total) // ps))
    bt, num_pages = _shuffled_tables(rng, total, ps, max_pages)
    g = torch.Generator(device=dev)
    g.manual_seed(int(rng.integers(1 << 30)))

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=dtype)

    return dict(
        q=randn(b, s, n_q, hd), k=randn(n_kv, num_pages, ps, hd), v=randn(n_kv, num_pages, ps, hd),
        bt=torch.from_numpy(bt).to(dev), cached=torch.tensor(cached, dtype=torch.int32, device=dev),
        new=torch.tensor(new, dtype=torch.int32, device=dev),
    )


def kernel_b_case(rng, dev, b, n_q, n_kv, hd, ps, pool_lens, n_steps, staged_len, n_layers=2,
                  dtype=None):
    import torch

    dtype = dtype or torch.bfloat16

    max_pages = max(1, -(-max(pool_lens) // ps))
    bt, num_pages = _shuffled_tables(rng, pool_lens, ps, max_pages)
    g = torch.Generator(device=dev)
    g.manual_seed(int(rng.integers(1 << 30)))

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=dtype)

    return dict(
        q=randn(b, 1, n_q, hd), k=randn(n_layers, n_kv, num_pages, ps, hd),
        v=randn(n_layers, n_kv, num_pages, ps, hd), bt=torch.from_numpy(bt).to(dev),
        pool=torch.tensor(pool_lens, dtype=torch.int32, device=dev),
        sk=randn(b, n_kv, n_steps, hd), sv=randn(b, n_kv, n_steps, hd),
        staged_len=staged_len, layer=n_layers - 1,
    )


def quantize_pools(k, v, quant: int):
    """int8 (quant 8) or int4 nibble-plane (quant 4) pools filled by
    commit_paged from the float pages ``k``/``v`` [..., P, ps, hd], so every
    (kv head, page) gets its own first-write scale: returns (kq, vq, ks,
    vs), pools [..., P + 1, ps, hd or hd // 2] with the drop page and scales
    [..., P + 1]."""
    import torch

    from githubrepostorag_tpu_torch.serving.kv_cache import commit_paged

    *lead, p, ps, hd = k.shape
    slots = torch.arange(p * ps, dtype=torch.int32, device=k.device)
    pools, scales = [], []
    for x in (k, v):
        pool = torch.zeros((*lead, p + 1, ps, hd if quant == 8 else hd // 2),
                           dtype=torch.int8 if quant == 8 else torch.uint8, device=k.device)
        sc = torch.zeros((*lead, p + 1), dtype=torch.float32, device=k.device)
        commit_paged(pool, x.reshape(*lead, p * ps, hd).float(), slots, ps, sc)
        pools.append(pool)
        scales.append(sc)
    return pools[0], pools[1], scales[0], scales[1]


def quantized_case(case, quant: int, n_layers: int | None = None) -> dict:
    """``case`` with its float pools replaced by quantized ones.  With
    ``n_layers`` (kernel B's rank-5 pools) the case's layer is committed
    into the LAST of ``n_layers`` int8 layers, and every other layer holds
    random codes and scales: a kernel that reads the wrong layer or scale
    disagrees with its plain version."""
    import torch

    if n_layers is None:
        kq, vq, ks, vs = quantize_pools(case["k"], case["v"], quant)
        return dict(case, k=kq, v=vq, ks=ks, vs=vs)
    li = case["layer"]
    kl, vl, ksl, vsl = quantize_pools(case["k"][li], case["v"][li], quant)
    dev = kl.device
    kq = torch.randint(-127, 128, (n_layers, *kl.shape), dtype=torch.int8, device=dev)
    vq = torch.randint(-127, 128, (n_layers, *kl.shape), dtype=torch.int8, device=dev)
    ks = torch.rand((n_layers, *ksl.shape), device=dev) * 0.05
    vs = torch.rand((n_layers, *ksl.shape), device=dev) * 0.05
    for dst, src in ((kq, kl), (vq, vl), (ks, ksl), (vs, vsl)):
        dst[-1].copy_(src)
    return dict(case, k=kq, v=vq, ks=ks, vs=vs, layer=n_layers - 1)


def _pool_elem_bytes(case) -> float:
    """Bytes per K or V element as the pools hold them (int4: half a byte)."""
    k = case["k"]
    return 0.5 if str(k.dtype) == "torch.uint8" else float(k.element_size())


def window_plan(q, k_pages, pool: str) -> dict:
    """Kernels A's and C's launch plan for these operands (q [B, S, ...] or
    [T, ...] of C, whose plan takes R and tq: the caller passes them as q)."""
    import torch

    from githubrepostorag_tpu_torch.ops.fused_decode import _plan_window

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    b, s, n_q, hd = q.shape
    return _plan_window(b, s, n_q, k_pages.shape[0], hd, k_pages.shape[2], n_sm,
                        route="wgmma" if q.dtype == torch.bfloat16 else "fma",
                        pool=pool)._asdict()


def measure_kernel_a(case, timed: bool) -> dict:
    import torch
    import torch.nn.functional as F

    from githubrepostorag_tpu_torch.ops.fused_decode import (
        fused_window_attention, fused_window_attention_ref)
    from githubrepostorag_tpu_torch.ops.paged_attention import gather_kv

    args = (case["q"], case["k"], case["v"], case["bt"], case["cached"], case["new"],
            case.get("ks"), case.get("vs"))
    out = fused_window_attention(*args)
    ref = fused_window_attention_ref(*args)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise RuntimeError("fused_window_attention produced non-finite values")
    b, s, n_q, hd = case["q"].shape
    n_kv = case["k"].shape[0]
    cached = case["cached"].tolist()
    total = [c + n for c, n in zip(cached, case["new"].tolist())]
    # rows with no valid KV must be exactly 0
    for i, t in enumerate(total):
        if t == 0 and out[i].abs().max().item() != 0.0:
            raise RuntimeError(f"row {i} has no valid KV but a non-zero output")
    res = agreement(out, ref)
    if not timed:
        return res
    res["plain_ms"] = time_ms(lambda: fused_window_attention_ref(*args), 3, warmup=1)
    # yardstick: one SDPA call over K/V gathered (and dequantized) beforehand
    k, v = gather_kv(case["k"], case["v"], case["bt"], case.get("ks"), case.get("vs"),
                     dtype=case["q"].dtype)  # [B, T, n_kv, hd]
    t = k.shape[1]
    kv_pos = torch.arange(t, device=k.device)
    q_pos = case["cached"].long()[:, None] + torch.arange(s, device=k.device)
    tot = torch.tensor(total, device=k.device)
    mask = (kv_pos[None, None] <= q_pos[:, :, None]) & (kv_pos[None, None] < tot[:, None, None])
    qs, ks, vs = case["q"].transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    res.update(device_timing(lambda: fused_window_attention(*args),
                             lambda: F.scaled_dot_product_attention(
                                 qs, ks, vs, attn_mask=mask[:, None], enable_gqa=True)))
    res["plan"] = window_plan(case["q"], case["k"], "fp" if "ks" not in case else (
        "int4" if str(case["k"].dtype) == "torch.uint8" else "int8"))
    keys = sum(min(c + ti + 1, tt) for c, tt in zip(cached, total) for ti in range(s))
    flops = 4.0 * hd * n_q * keys
    nbytes = (case["q"].element_size() * 2 * b * s * n_q * hd
              + _pool_elem_bytes(case) * 2 * sum(total) * n_kv * hd)
    if "ks" in case:  # one f32 scale per (kv head, page) read, for K and V
        ps = case["k"].shape[2]
        nbytes += 4 * 2 * n_kv * sum(-(-t // ps) for t in total)
    res["bound_ms"], res["bound_by"] = bound(flops, nbytes)
    return res


def launch_decode_plan(case, pps: int, out):
    """Kernel B (a case with a staged tail) or F through its C entry point
    with ``pps`` pages per split instead of the plan's (no count): the
    split sweep of the kernel phase."""
    import torch

    from githubrepostorag_tpu_torch import kernels
    from githubrepostorag_tpu_torch.ops import paged_decode as ops
    from githubrepostorag_tpu_torch.ops.fused_decode import POOL_CODES

    q, bt = case["q"], case["bt"]
    b, _, n_q, hd = q.shape
    max_pages = bt.shape[1]
    n_splits = -(-max_pages // pps)
    ws = ops._workspace(b * case["k"].shape[-4] * (n_splits + 1), hd, q.device)
    stream = torch.cuda.current_stream().cuda_stream
    if "sk" in case:  # kernel B, rank-5 pools
        _, n_kv, num_pages, ps, _ = case["k"].shape
        ks, vs = case.get("ks"), case.get("vs")
        err = kernels.launcher("paged_decode_staged")(
            q.data_ptr(), case["k"].data_ptr(), case["v"].data_ptr(), case["sk"].data_ptr(),
            case["sv"].data_ptr(), out.data_ptr(), bt.data_ptr(), case["pool"].data_ptr(),
            None if ks is None else ks.data_ptr(), None if vs is None else vs.data_ptr(),
            ws.data_ptr(), ops._counters(b * n_kv, q.device).data_ptr(), b, n_q, n_kv,
            num_pages, ps, hd, max_pages, case["sk"].shape[2],
            case["staged_len"], case["layer"], ops._DTYPES[q.dtype],
            POOL_CODES["fp" if ks is None else "int8"], pps, n_splits, 1.0 / hd ** 0.5, stream)
    else:
        n_kv, num_pages, ps, _ = case["k"].shape
        err = kernels.launcher("paged_decode")(
            q.data_ptr(), case["k"].data_ptr(), case["v"].data_ptr(), out.data_ptr(),
            bt.data_ptr(), case["cached"].data_ptr(), case["new"].data_ptr(), ws.data_ptr(),
            ops._counters(b * n_kv, q.device).data_ptr(), b, n_q, n_kv, num_pages, ps, hd,
            max_pages, ops._DTYPES[q.dtype], pps, n_splits,
            1.0 / hd ** 0.5, stream)
    kernels.check_launch("decode split sweep", err)


def device_timing(fn, library_fn) -> dict:
    """A kernel's times: device time per call from the profiler (by kernel
    name, ``kernels_us``) as ``ms``; the same calls by CUDA events with the
    wrapper's host time in them as ``events_ms``; the wrapper's host time per
    call alone (``host_us``: launches queued back to back, no wait; it
    encodes the tensor maps at each launch); the library yardstick by device
    time (``library_ms``) and by events."""
    import torch

    res = {"events_ms": time_ms(fn, 50)}
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        fn()
    res["host_us"] = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    res["kernels_us"] = device_us(fn)
    res["ms"] = sum(res["kernels_us"].values()) / 1e3
    res["library_ms"] = sum(device_us(library_fn).values()) / 1e3
    res["library_events_ms"] = time_ms(library_fn, 50)
    return res


def decode_timing(case, fn, ref, library_fn) -> dict:
    """Kernel B's or F's times: device time per call from the profiler (by
    kernel name, ``kernels_us``) as ``ms``, the same
    calls by CUDA events with the host's wrapper time in them as
    ``events_ms``; the plain version; the SDPA yardstick by device time and
    by events.  Then the split sweep: every pages-per-split the page size
    allows up to 32, each held to the plain version, device us per call."""
    import torch

    from githubrepostorag_tpu_torch.device import sm_count
    from githubrepostorag_tpu_torch.ops.paged_decode import _plan_decode

    # where the device work is shorter than the wrapper's (batch 1), the
    # events time is the host's
    res = device_timing(fn, library_fn)
    ps, max_pages = case["k"].shape[-2], case["bt"].shape[1]
    b, n_kv = case["q"].shape[0], case["k"].shape[-4]
    res["plan"] = _plan_decode(b, n_kv, max_pages, ps, sm_count(case["q"].device))._asdict()
    unit = max(1, 64 // ps)
    sweep = {}
    for pps in sorted({unit * m for m in (1, 2, 4, 8, 16, 32)}):
        if pps > max_pages * 2 or pps > 256:
            continue
        out = torch.empty_like(case["q"])
        launch_decode_plan(case, pps, out)
        torch.cuda.synchronize()
        if not agreement(out, ref)["limit_share"] <= 1.0:
            raise RuntimeError(f"decode kernel with {pps} pages per split disagrees with its "
                               "plain version")
        sweep[pps] = sum(device_us(lambda: launch_decode_plan(case, pps, out)).values())
    res["split_sweep_us"] = sweep
    return res


def measure_kernel_b(case, timed: bool) -> dict:
    import torch
    import torch.nn.functional as F

    from githubrepostorag_tpu_torch.ops.paged_attention import gather_kv
    from githubrepostorag_tpu_torch.ops.paged_decode import (
        paged_attention_decode_staged, paged_attention_decode_staged_ref)

    args = (case["q"], case["k"], case["v"], case["bt"], case["pool"], case["sk"], case["sv"],
            case["staged_len"], case["layer"], case.get("ks"), case.get("vs"))
    out = paged_attention_decode_staged(*args)
    ref = paged_attention_decode_staged_ref(*args)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise RuntimeError("paged_attention_decode_staged produced non-finite values")
    res = agreement(out, ref)
    if not timed:
        return res
    b, _, n_q, hd = case["q"].shape
    n_kv = case["k"].shape[1]
    pool = case["pool"].tolist()
    sl = case["staged_len"]
    res["plain_ms"] = time_ms(lambda: paged_attention_decode_staged_ref(*args), 5, warmup=1)
    li = case["layer"]
    pk, pv = gather_kv(case["k"][li], case["v"][li], case["bt"],
                       case["ks"][li] if "ks" in case else None,
                       case["vs"][li] if "vs" in case else None, dtype=case["q"].dtype)
    k = torch.cat([pk, case["sk"].transpose(1, 2)], dim=1).transpose(1, 2)
    v = torch.cat([pv, case["sv"].transpose(1, 2)], dim=1).transpose(1, 2)
    t = pk.shape[1]
    n_steps = case["sk"].shape[2]
    valid = torch.cat([
        torch.arange(t, device=k.device)[None] < case["pool"][:, None],
        (torch.arange(n_steps, device=k.device) < sl)[None].expand(b, n_steps)], dim=1)
    qs = case["q"].transpose(1, 2)
    res.update(decode_timing(case, lambda: paged_attention_decode_staged(*args), ref,
                             lambda: F.scaled_dot_product_attention(
                                 qs, k, v, attn_mask=valid[:, None, None], enable_gqa=True)))
    keys = sum(pool) + b * sl
    flops = 4.0 * hd * n_q * keys
    elem = case["q"].element_size()
    nbytes = (elem * 2 * b * n_q * hd + elem * 2 * b * sl * n_kv * hd
              + _pool_elem_bytes(case) * 2 * sum(pool) * n_kv * hd)
    if "ks" in case:
        ps = case["k"].shape[3]
        nbytes += 4 * 2 * n_kv * sum(-(-n // ps) for n in pool)
    res["bound_ms"], res["bound_by"] = bound(flops, nbytes)
    return res


def kernel_f_case(rng, dev, lens, n_q=28, n_kv=4, hd=128, ps=128, dtype=None):
    """One decode query per row over one layer's rank-4 pool: row lengths
    ``lens`` (cached len - 1, new 1; a 0 is a padding row with nothing
    cached), shuffled tables over a pool with holes, and every table entry
    past a row's pages set to -1, which the kernel must never read."""
    import torch

    dtype = dtype or torch.bfloat16
    max_pages = max(1, -(-max(lens) // ps))
    bt, num_pages = _shuffled_tables(rng, lens, ps, max_pages)
    for i, n in enumerate(lens):
        bt[i, -(-n // ps):] = -1
    g = torch.Generator(device=dev)
    g.manual_seed(int(rng.integers(1 << 30)))

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=dtype)

    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)  # noqa: E731
    return dict(q=randn(len(lens), 1, n_q, hd), k=randn(n_kv, num_pages, ps, hd),
                v=randn(n_kv, num_pages, ps, hd), bt=torch.from_numpy(bt).to(dev),
                cached=i32([max(n - 1, 0) for n in lens]), new=i32([int(n > 0) for n in lens]))


def measure_kernel_f(case, timed: bool) -> dict:
    """Kernel F against its plain version and against kernel A at S = 1
    (both hand-written kernels compute the same function there); rows with
    no key must be exactly 0."""
    import torch
    import torch.nn.functional as F

    from githubrepostorag_tpu_torch.ops.fused_decode import fused_window_attention
    from githubrepostorag_tpu_torch.ops.paged_attention import gather_kv
    from githubrepostorag_tpu_torch.ops.paged_decode import (
        paged_attention_decode, paged_attention_decode_ref)

    args = (case["q"], case["k"], case["v"], case["bt"], case["cached"], case["new"])
    out = paged_attention_decode(*args)
    ref = paged_attention_decode_ref(*args)
    via_a = fused_window_attention(*args)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise RuntimeError("paged_attention_decode produced non-finite values")
    total = (case["cached"] + case["new"]).tolist()
    for i, t in enumerate(total):
        if t == 0 and out[i].abs().max().item() != 0.0:
            raise RuntimeError(f"row {i} has no key but a non-zero output")
    res = agreement(out, ref)
    res_a = agreement(out, via_a)
    res["vs_kernel_a_max_abs_err"] = res_a["max_abs_err"]
    res["vs_kernel_a_limit_share"] = res_a["limit_share"]
    if not timed:
        return res
    b, _, n_q, hd = case["q"].shape
    n_kv = case["k"].shape[0]
    res["plain_ms"] = time_ms(lambda: paged_attention_decode_ref(*args), 5, warmup=1)
    # yardstick: one SDPA call over K/V gathered beforehand (-1 entries
    # gather the pool's last page, masked)
    k, v = gather_kv(case["k"], case["v"], case["bt"])
    valid = torch.arange(k.shape[1], device=k.device)[None] < torch.tensor(
        total, device=k.device)[:, None]
    qs, ks, vs = case["q"].transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    res.update(decode_timing(case, lambda: paged_attention_decode(*args), ref,
                             lambda: F.scaled_dot_product_attention(
                                 qs, ks, vs, attn_mask=valid[:, None, None], enable_gqa=True)))
    elem = case["q"].element_size()
    nbytes = elem * (2 * b * n_q * hd + 2 * sum(total) * n_kv * hd)
    res["bound_ms"], res["bound_by"] = bound(4.0 * hd * n_q * sum(total), nbytes)
    return res


def kernel_c_case(rng, dev, n_q, n_kv, hd, ps, cached, new, tq, budget, dtype):
    """A packed buffer of ``budget`` tokens: segment r's ``new[r]`` tokens
    at positions cached[r].., back to back, then padding tokens; shuffled
    block tables over a pool with holes."""
    import torch

    total = [c + n for c, n in zip(cached, new)]
    max_pages = -(-max(total) // ps)
    bt, num_pages = _shuffled_tables(rng, total, ps, max_pages)
    seg, pos = [], []
    for r, (c, n) in enumerate(zip(cached, new)):
        seg += [r] * n
        pos += list(range(c, c + n))
    pad = budget - len(seg)
    seg += [len(cached)] * pad
    pos += [0] * pad
    g = torch.Generator(device=dev)
    g.manual_seed(int(rng.integers(1 << 30)))

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=dtype)

    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)  # noqa: E731
    return dict(q=randn(budget, n_q, hd), k=randn(n_kv, num_pages, ps, hd),
                v=randn(n_kv, num_pages, ps, hd), bt=torch.from_numpy(bt).to(dev),
                cached=i32(cached), new=i32(new), seg=i32(seg), pos=i32(pos), tq=tq)


def measure_kernel_c(case, timed: bool) -> dict:
    import torch
    import torch.nn.functional as F

    from githubrepostorag_tpu_torch.ops.packed_prefill import (
        _segment_scatter_indices, packed_prefill_attention_ref, packed_prefill_attention_seg)
    from githubrepostorag_tpu_torch.ops.paged_attention import gather_kv

    args = (case["q"], case["k"], case["v"], case["bt"], case["cached"], case["new"],
            case["seg"], case["pos"])
    tq = case["tq"]
    out = packed_prefill_attention_seg(*args, tq=tq)
    ref = packed_prefill_attention_ref(*args, tq=tq)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise RuntimeError("packed_prefill_attention_seg produced non-finite values")
    r = case["bt"].shape[0]
    if out[case["seg"] >= r].abs().max().item() != 0.0:
        raise RuntimeError("packed_prefill_attention_seg wrote a padding token")
    res = agreement(out, ref)
    if not timed:
        return res
    res["plain_ms"] = time_ms(lambda: packed_prefill_attention_ref(*args, tq=tq), 3, warmup=1)
    # yardstick: one SDPA call on the segment-major view, queries scattered
    # and K/V gathered beforehand, with kernel A's yardstick mask
    t, n_q, hd = case["q"].shape
    n_kv = case["k"].shape[0]
    dest = _segment_scatter_indices(case["seg"], case["pos"], case["cached"], tq).long()
    q_seg = torch.zeros((r * tq + 1, n_q, hd), dtype=case["q"].dtype, device=out.device)
    q_seg.index_copy_(0, dest, case["q"])
    q_seg = q_seg[: r * tq].reshape(r, tq, n_q, hd).transpose(1, 2)
    k, v = gather_kv(case["k"], case["v"], case["bt"])
    kv_pos = torch.arange(k.shape[1], device=k.device)
    q_pos = case["cached"].long()[:, None] + torch.arange(tq, device=k.device)
    tot = (case["cached"] + case["new"]).long()
    mask = (kv_pos[None, None] <= q_pos[:, :, None]) & (kv_pos[None, None] < tot[:, None, None])
    ks, vs = k.transpose(1, 2), v.transpose(1, 2)
    # the wrapper's device time (``wrapper_ms``) includes its row_of scatter
    # and zeroed output (a few small kernels, named in ``kernels_us``); ``ms``
    # is kernel C's own
    res.update(device_timing(lambda: packed_prefill_attention_seg(*args, tq=tq),
                             lambda: F.scaled_dot_product_attention(
                                 q_seg, ks, vs, attn_mask=mask[:, None], enable_gqa=True)))
    res["wrapper_ms"] = res["ms"]
    res["ms"] = sum(us for name, us in res["kernels_us"].items() if "prefill_kernel" in name) / 1e3
    res["plan"] = window_plan(q_seg.transpose(1, 2), case["k"], "fp")
    # the bound counts each segment's real tokens, not R * tq
    cached, new = case["cached"].tolist(), case["new"].tolist()
    keys = sum(c + i + 1 for c, n in zip(cached, new) for i in range(n))
    elem = case["q"].element_size()
    nbytes = elem * (2 * sum(new) * n_q * hd + 2 * sum(c + n for c, n in zip(cached, new))
                     * n_kv * hd)
    res["bound_ms"], res["bound_by"] = bound(4.0 * hd * n_q * keys, nbytes)
    return res


def window_rows_invariant(rng, dev) -> None:
    """Kernel A gives a row's real positions bit for bit the same output
    at every window of the width ladder: the same rows (a row resuming
    past 1024 cached keys, one from 0, one at the long-context 7808) at S
    = 128 and 256 against S = 512, bf16 and int8 pages."""
    import torch

    from githubrepostorag_tpu_torch.ops.fused_decode import fused_window_attention

    new = [100, 100, 100]
    base = kernel_a_case(rng, dev, 3, 512, 28, 4, 128, 128, cached=[1024, 0, 7808], new=new)
    for case in (base, quantized_case(base, 8)):
        args = [case[k] for k in ("k", "v", "bt", "cached", "new")] + [case.get("ks"),
                                                                      case.get("vs")]
        full = fused_window_attention(case["q"], *args)
        for s in (256, 128):
            out = fused_window_attention(case["q"][:, :s].contiguous(), *args)
            if any(not torch.equal(out[i, :n], full[i, :n]) for i, n in enumerate(new)):
                raise RuntimeError(f"kernel A rows differ at S = {s} from S = 512 "
                                   f"({'int8' if 'ks' in case else 'fp'} pages)")
    log("kernel A: rows at S = 128 and 256 equal S = 512 bit for bit (fp and int8 pages)")


def gemm_row_invariance(floor: int = 512) -> dict:
    """Which 7B bf16 projections give a row another result when the GEMM
    has fewer rows: ``x[:m] @ w`` against the first m rows of ``x @ w`` at
    4096 rows, for m from 128 to 2048 (rows whose output differs in any
    bit).  cuBLAS picks its algorithm by shape.  The engine keeps every
    padded prefill dispatch at ``prefill_row_floor`` (= ``prefill_chunk``,
    512 in the engine phases) tokens or more, so that a wave's rows do not
    depend on its width: raises if any row differs at ``floor`` rows or
    more.  Below the floor, the count is what the floor avoids."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 17)
    out = {}
    for name, (k, n) in {"wqkv": (3584, 4608), "wo": (3584, 3584), "wgu": (3584, 37888),
                         "wd": (18944, 3584)}.items():
        w = torch.randn(k, n, generator=gen, device="cuda", dtype=torch.bfloat16) * 0.02
        x = torch.randn(4096, k, generator=gen, device="cuda", dtype=torch.bfloat16)
        ref = x @ w
        out[name] = {m: int((x[:m] @ w != ref[:m]).any(dim=1).sum())
                     for m in (128, 256, 384, 512, 1024, 2048)}
        del w, x, ref
    torch.cuda.empty_cache()
    log(f"bf16 GEMM rows differing from the 4096-row result, by rows: {json.dumps(out)}")
    moved = {name: {m: n for m, n in by_m.items() if m >= floor and n}
             for name, by_m in out.items()}
    if any(moved.values()):
        raise RuntimeError(f"bf16 GEMM rows differ from the 4096-row result at {floor} rows "
                           f"or more, where the engine's prefill row floor needs none: {moved}")
    return out


def phase_kernels() -> dict:
    import torch

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    results = {}
    checks = []  # (case, agreement) of every comparison

    def check(label, res):
        checks.append((label, res))
        log(f"{label}: {json.dumps(res)}")
        return res

    # small cases in both dtypes: group 2, head_dim 64, a row with no KV;
    # quantized pools filled by commit_paged (scales vary per page and head)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        case = kernel_a_case(rng, dev, 3, 5, 4, 2, 64, 8, cached=[0, 9, 0], new=[5, 3, 0],
                             dtype=dtype)
        check(f"kernel A small {name} (group 2, hd 64)", measure_kernel_a(case, False))
        for quant in (8, 4):
            check(f"kernel A int{quant} small {name}",
                  measure_kernel_a(quantized_case(case, quant), False))
        case = kernel_b_case(rng, dev, 3, 4, 2, 64, 8, [0, 21, 40], n_steps=4, staged_len=2,
                             dtype=dtype)
        check(f"kernel B small {name} (group 2, hd 64)", measure_kernel_b(case, False))
        check(f"kernel B int8 small {name}",
              measure_kernel_b(quantized_case(case, 8, n_layers=3), False))
        check(f"kernel C small {name} (group 2, hd 64)", measure_kernel_c(kernel_c_case(
            rng, dev, 4, 2, 64, 8, cached=[3, 0, 17], new=[6, 8, 2], tq=8, budget=20,
            dtype=dtype), False))
        check(f"kernel F small {name} (group 2, hd 64)", measure_kernel_f(kernel_f_case(
            rng, dev, [13, 0, 40, 1], n_q=4, n_kv=2, hd=64, ps=8, dtype=dtype), False))

    # kernel A at the main prefill shape: B=4, S=512, 28/4 heads, hd 128,
    # ps 128, contexts to 4096, in all three pool branches; float32 for the
    # tight limit, bf16 timed
    for dtype in (torch.float32, torch.bfloat16):
        main = kernel_a_case(rng, dev, 4, 512, 28, 4, 128, 128, cached=[0, 1024, 2560, 3584],
                             new=[512, 512, 300, 512], dtype=dtype)
        timed = dtype == torch.bfloat16
        name = str(dtype)[6:]
        res = check(f"kernel A B=4 S=512 ctx<=4096 {name}", measure_kernel_a(main, timed))
        for quant in (8, 4):
            resq = check(f"kernel A int{quant} B=4 S=512 ctx<=4096 {name}",
                         measure_kernel_a(quantized_case(main, quant), timed))
            if timed:
                results[f"fused_window_attention@int{quant}"] = resq
        del main
    results["fused_window_attention"] = res

    # kernels A and C at their tile edges, in both dtypes: group 7's flat
    # rows across 128-row tiles with a row of no key (total 0) and a cached
    # length mid-page; 8-key pages at hd 64, int4 there too; C with group 7
    # at hd 64 over 8-key pages, one segment empty
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        for label, args in (
                ("group 7 S=37 ps 64 totals [137, 20, 0]",
                 (3, 37, 7, 1, 128, 64, [100, 0, 0], [37, 20, 0])),
                ("group 7 hd 64 ps 8 S=70", (2, 70, 14, 2, 64, 8, [33, 5], [70, 9]))):
            b, s_w, n_q, n_kv, hd, ps, cached, new = args
            case = kernel_a_case(rng, dev, b, s_w, n_q, n_kv, hd, ps, cached=cached, new=new,
                                 dtype=dtype)
            check(f"kernel A {label} {name}", measure_kernel_a(case, False))
            for quant in (8, 4):
                check(f"kernel A int{quant} {label} {name}",
                      measure_kernel_a(quantized_case(case, quant), False))
        check(f"kernel C group 7 hd 64 ps 8 segments [70, 19, 0] {name}", measure_kernel_c(
            kernel_c_case(rng, dev, 14, 2, 64, 8, cached=[33, 0, 5], new=[70, 19, 0], tq=70,
                          budget=96, dtype=dtype), False))

    # kernel A at the long-context profile's launch: 8 rows recomputing their
    # last page (S = 128) over 7936 keys, 28/4 heads, hd 128, ps 128; bf16
    # pages and int8 pages, timed
    lc = kernel_a_case(rng, dev, 8, 128, 28, 4, 128, 128, cached=[7808] * 8, new=[128] * 8)
    results["fused_window_attention@longctx"] = check(
        "kernel A long context B=8 S=128 cached 7808 bfloat16", measure_kernel_a(lc, True))
    results["fused_window_attention@int8@longctx"] = check(
        "kernel A int8 long context B=8 S=128 cached 7808 bfloat16",
        measure_kernel_a(quantized_case(lc, 8), True))
    del lc
    # the launch as the engine makes it: padded prefill's window is the
    # whole prefill_chunk (512), of which the last page's 128 tokens are new
    lc = kernel_a_case(rng, dev, 8, 512, 28, 4, 128, 128, cached=[7808] * 8, new=[128] * 8)
    results["fused_window_attention@longctx512"] = check(
        "kernel A long context B=8 S=512 (128 new) cached 7808 bfloat16",
        measure_kernel_a(lc, True))
    del lc
    # the width ladder's middle window (prefill_widths=3): S = 256 for a
    # wave whose longest pending chunk is 129..256 tokens, here ragged last
    # chunks of extractor-sized prompts (to ~3,300 tokens); float32 for the
    # tight limit, bf16 timed, full-precision and int8 pages
    for dtype in (torch.float32, torch.bfloat16):
        w256 = kernel_a_case(rng, dev, 4, 256, 28, 4, 128, 128, cached=[3072, 2560, 1024, 0],
                             new=[228, 256, 180, 256], dtype=dtype)
        timed, name = dtype == torch.bfloat16, str(dtype)[6:]
        res = check(f"kernel A B=4 S=256 ctx<=3300 {name}", measure_kernel_a(w256, timed))
        resq = check(f"kernel A int8 B=4 S=256 ctx<=3300 {name}",
                     measure_kernel_a(quantized_case(w256, 8), timed))
        if timed:
            results["fused_window_attention@S256"] = res
            results["fused_window_attention@int8@S256"] = resq
        del w256
    results.update(verify_window_cases(rng, dev, check))
    results.update(draft_window_cases(rng, dev, check))
    results.update(moe_group1_cases(np.random.default_rng(SEED + 89), dev, check))
    window_rows_invariant(rng, dev)
    results["gemm_rows"] = gemm_row_invariance()
    torch.cuda.empty_cache()

    # kernel B: rank-5 pools, mid-burst staged tail; full precision at
    # layer 1 of 2, int8 at layer 27 of 28 with a staged tail in the
    # activation dtype
    for b, dtype in ((8, torch.float32), (8, torch.bfloat16), (64, torch.bfloat16)):
        pool = rng.integers(1, 8193, size=b)
        pool[0] = 8192
        case = kernel_b_case(rng, dev, b, 28, 4, 128, 128, pool.tolist(), n_steps=8, staged_len=5,
                             dtype=dtype)
        timed = dtype == torch.bfloat16
        label = f"B={b} pool<=8192 n_steps 8 {str(dtype)[6:]}"
        suffix = "" if b == 8 else f"@B{b}"
        res = check(f"kernel B {label}", measure_kernel_b(case, timed))
        if timed:
            results["paged_attention_decode_staged" + suffix] = res
        case = quantized_case(dict(case, k=case["k"][-1:], v=case["v"][-1:], layer=0), 8,
                              n_layers=28)
        res = check(f"kernel B int8 layer 27 of 28 {label}", measure_kernel_b(case, timed))
        if timed:
            results["paged_attention_decode_staged@int8" + suffix] = res
        del case
        torch.cuda.empty_cache()
    for key in ("paged_attention_decode_staged", "paged_attention_decode_staged@int8"):
        results[key]["max_abs_err"] = max(results[key]["max_abs_err"],
                                          results[key + "@B64"]["max_abs_err"])

    # kernel F: one layer's rank-4 pool at 7B decode geometry, contexts to
    # 8192; row 1 ends mid-page, row 2 is a padding row (no key)
    for b, dtype in ((8, torch.float32), (8, torch.bfloat16), (64, torch.bfloat16)):
        lens = rng.integers(1, 8193, size=b)
        lens[0], lens[1], lens[2] = 8192, 1000, 0
        case = kernel_f_case(rng, dev, lens.tolist(), dtype=dtype)
        timed = dtype == torch.bfloat16
        suffix = "" if b == 8 else f"@B{b}"
        res = check(f"kernel F B={b} ctx<=8192 {str(dtype)[6:]}", measure_kernel_f(case, timed))
        if timed:
            results["paged_attention_decode" + suffix] = res
        del case
    results["paged_attention_decode"]["max_abs_err"] = max(
        results["paged_attention_decode"]["max_abs_err"],
        results["paged_attention_decode@B64"]["max_abs_err"])

    # the split-K cases (7B heads, hd 128, ps 128, bf16 and float32): batch
    # 1 at 8192 keys, the case split-K exists for (timed in bf16); rows
    # ending exactly on a split edge, one key past it, one key, and an empty
    # row (F: no key; B: pool_len 0, the staged tail alone), the edge taken
    # from the wrapper's plan at this batch and table width
    from githubrepostorag_tpu_torch.ops.paged_decode import _plan_decode
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    edge = _plan_decode(5, 4, 64, 128, n_sm).pages_per_split * 128 * 3
    for dtype in (torch.float32, torch.bfloat16):
        name, timed = str(dtype)[6:], dtype == torch.bfloat16
        res = check(f"kernel B B=1 pool 8192 {name}", measure_kernel_b(kernel_b_case(
            rng, dev, 1, 28, 4, 128, 128, [8192], n_steps=8, staged_len=8, dtype=dtype), timed))
        if timed:
            results["paged_attention_decode_staged@B1"] = res
        res = check(f"kernel F B=1 ctx 8192 {name}", measure_kernel_f(kernel_f_case(
            rng, dev, [8192], dtype=dtype), timed))
        if timed:
            results["paged_attention_decode@B1"] = res
        lens = [8192, edge, edge + 1, 1, 0]
        case = kernel_b_case(rng, dev, 5, 28, 4, 128, 128, lens, n_steps=8, staged_len=3,
                             dtype=dtype)
        check(f"kernel B split edges {lens} {name}", measure_kernel_b(case, False))
        check(f"kernel B int8 split edges {lens} {name}",
              measure_kernel_b(quantized_case(case, 8, n_layers=3), False))
        check(f"kernel F split edges {lens} {name}", measure_kernel_f(kernel_f_case(
            rng, dev, lens, dtype=dtype), False))
        # small pages: 8-key pages at hd 64, eight to a tile, many splits
        case = kernel_b_case(rng, dev, 3, 4, 2, 64, 8, [1000, 64, 0], n_steps=4, staged_len=4,
                             dtype=dtype)
        check(f"kernel B ps 8 hd 64 pool [1000, 64, 0] {name}", measure_kernel_b(case, False))
        check(f"kernel B int8 ps 8 hd 64 pool [1000, 64, 0] {name}",
              measure_kernel_b(quantized_case(case, 8, n_layers=2), False))
        check(f"kernel F ps 8 hd 64 ctx [1000, 65, 0] {name}", measure_kernel_f(kernel_f_case(
            rng, dev, [1000, 65, 0], n_q=4, n_kv=2, hd=64, ps=8, dtype=dtype), False))
        del case
        torch.cuda.empty_cache()

    # kernel C: a packed buffer of 2048 tokens at 7B heads, tq 512: five
    # segments (one resuming mid-page at 2500) and 124 padding tokens
    for dtype in (torch.float32, torch.bfloat16):
        case = kernel_c_case(rng, dev, 28, 4, 128, 128, cached=[0, 1024, 2500, 0, 3000],
                             new=[512, 512, 300, 500, 100], tq=512, budget=2048, dtype=dtype)
        res = check(f"kernel C T=2048 R=5 tq=512 {str(dtype)[6:]}",
                    measure_kernel_c(case, dtype == torch.bfloat16))
        del case
    results["packed_prefill_attention_seg"] = res

    limits = ", ".join(f"{k[6:]} {a:g} + {r:g}|ref|" for k, (a, r) in KERNEL_TOL.items())
    # kernel F is also held to kernel A at S = 1
    bad = [label for label, r in checks
           if not (r["limit_share"] <= 1.0 and r.get("vs_kernel_a_limit_share", 0.0) <= 1.0)]
    if bad:
        raise RuntimeError(f"kernel and plain version disagree beyond {limits}: {bad}")
    log(f"kernels agree with their plain versions element-wise within {limits}")
    return results


def verify_window_cases(rng, dev, check) -> dict:
    """Kernel A at the speculative verify window: B=8 rows, S = k+1 = 5,
    28/4 heads, hd 128, 128-key pages, contexts to 2048; new tokens 5, 5,
    4, 3, 2 and 1 (short or no drafts), 0 on a row at its page limit
    (cached 2000) and 0 on a bucket padding row (no key, a zero block
    table: its output must be exactly 0).  fp, int8 and int4 pools, float32
    for the tight limit, bf16 timed against its bound and SDPA."""
    import torch

    out = {}
    cached, new = [2043, 1500, 777, 128, 64, 1, 2000, 0], [5, 5, 4, 3, 2, 1, 0, 0]
    for dtype in (torch.float32, torch.bfloat16):
        case = kernel_a_case(rng, dev, 8, 5, 28, 4, 128, 128, cached=cached, new=new,
                             dtype=dtype)
        timed, name = dtype == torch.bfloat16, str(dtype)[6:]
        for quant, key in ((0, "fused_window_attention@S5"),
                           (8, "fused_window_attention@int8@S5"),
                           (4, "fused_window_attention@int4@S5")):
            qcase = case if quant == 0 else quantized_case(case, quant)
            label = "" if quant == 0 else f" int{quant}"
            res = check(f"kernel A{label} verify window B=8 S=5 new 0..5 ctx<=2048 {name}",
                        measure_kernel_a(qcase, timed))
            if timed:
                out[key] = res
        del case
    return out


def draft_window_cases(rng, dev, check) -> dict:
    """Kernel A at the draft-model path's shapes: the draft's step (B=8,
    S=1, 14/2 heads -- group 7 --, hd 64, 128-key pages, contexts to 2048,
    one bucket padding row with no key), the draft's prefill (B=4, S=512,
    hd 64), and the target's verify rungs below the top one (B=8, S = 2
    and 3, 28/4 heads, hd 128, new 0..S).  fp pools, float32 for the tight
    limit, bf16 timed against its bound and SDPA."""
    import torch

    out = {}
    cases = (
        ("draft_S1", "draft step B=8 S=1 14/2 hd 64 ctx<=2048",
         dict(b=8, s=1, n_q=14, n_kv=2, hd=64, cached=[2047, 1500, 777, 128, 64, 1, 2000, 0],
              new=[1, 1, 1, 1, 1, 1, 1, 0])),
        ("draft_S512", "draft prefill B=4 S=512 14/2 hd 64 ctx<=2048",
         dict(b=4, s=512, n_q=14, n_kv=2, hd=64, cached=[0, 1024, 1500, 512],
              new=[512, 512, 300, 512])),
        ("S2", "verify rung B=8 S=2 28/4 hd 128 ctx<=2048",
         dict(b=8, s=2, n_q=28, n_kv=4, hd=128, cached=[2046, 1500, 777, 128, 64, 1, 2000, 0],
              new=[2, 2, 1, 2, 1, 2, 0, 0])),
        ("S3", "verify rung B=8 S=3 28/4 hd 128 ctx<=2048",
         dict(b=8, s=3, n_q=28, n_kv=4, hd=128, cached=[2045, 1500, 777, 128, 64, 1, 2000, 0],
              new=[3, 3, 2, 1, 3, 3, 0, 0])),
    )
    for key, label, kw in cases:
        for dtype in (torch.float32, torch.bfloat16):
            case = kernel_a_case(rng, dev, kw["b"], kw["s"], kw["n_q"], kw["n_kv"], kw["hd"],
                                 128, cached=kw["cached"], new=kw["new"], dtype=dtype)
            timed = dtype == torch.bfloat16
            res = check(f"kernel A {label} {str(dtype)[6:]}", measure_kernel_a(case, timed))
            if timed:
                out[f"fused_window_attention@{key}"] = res
            del case
    return out


def phase_dispatcher() -> dict:
    """Kernel F's path, the ``paged_attention`` dispatcher, on the 7B decode
    case: every launch count is set to 0 just before each call and read
    just after.  S = 1 must launch F exactly once and nothing else; S = 512
    must launch nothing and equal ``paged_attention_ref``."""
    import torch

    from githubrepostorag_tpu_torch.ops.paged_attention import paged_attention_ref
    from githubrepostorag_tpu_torch.ops.paged_decode import (
        paged_attention, paged_attention_decode_ref)

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 7)
    lens = rng.integers(1, 8193, size=8)
    lens[1] = 0
    case = kernel_f_case(rng, dev, lens.tolist())
    args = (case["q"], case["k"], case["v"], case["bt"], case["cached"], case["new"])
    reset_launches()
    out = paged_attention(*args)
    torch.cuda.synchronize()
    launches = read_launches()
    want = {k: int(k == "paged_attention_decode") for k in launches}
    if launches != want:
        raise RuntimeError(f"paged_attention at S=1 launched {launches}, expected only F once")
    res = agreement(out, paged_attention_decode_ref(*args))
    if not res["limit_share"] <= 1.0:
        raise RuntimeError(f"paged_attention at S=1 disagrees with F's plain version: {res}")

    # a prefill chunk: 512 new tokens on contexts of 0..2048
    cached = [0, 700, 1536, 2048]
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 8)
    q = torch.randn((4, 512, 28, 128), generator=g, device=dev, dtype=torch.bfloat16)
    bt, num_pages = _shuffled_tables(rng, [c + 512 for c in cached], 128, 20)
    kp = torch.randn((4, num_pages, 128, 128), generator=g, device=dev, dtype=torch.bfloat16)
    vp = torch.randn_like(kp)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)  # noqa: E731
    args = (q, kp, vp, torch.from_numpy(bt).to(dev), i32(cached), i32([512] * 4))
    reset_launches()
    out = paged_attention(*args)
    torch.cuda.synchronize()
    launches_prefill = read_launches()
    if any(launches_prefill.values()):
        raise RuntimeError(f"paged_attention at S=512 launched {launches_prefill}")
    if not torch.equal(out, paged_attention_ref(*args)):
        raise RuntimeError("paged_attention at S=512 differs from paged_attention_ref")
    log(f"dispatcher: S=1 launched {launches['paged_attention_decode']} x F and nothing else "
        f"(vs plain {json.dumps(res)}); S=512 launched nothing and equals paged_attention_ref")
    return {"launches": launches}


# ------------------------------------------------------- int4 GEMMs (D, E) --

# (name, K, N) of the Qwen2-7B int4 projections in the fused serving layout
Q7B_SHAPES = {"wqkv": (3584, 4608), "wo": (3584, 3584), "wgu": (3584, 37888),
              "wd": (18944, 3584), "lm_head": (3584, 152064)}


def int4_case(gen, k, n, layers=None):
    """A QuantizedLinear4 from quantize_weight4 of a random normal matrix
    (so every group and column has its own scales), as a contiguous
    per-layer tensor and, with ``layers``, also as the LAST layer's view of
    a stack whose other layers hold other bytes: a kernel that reads the
    wrong layer or offset disagrees with the plain version."""
    import torch

    from githubrepostorag_tpu_torch.models.quant import QuantizedLinear4, quantize_weight4

    w = quantize_weight4(torch.randn((k, n), generator=gen, device="cuda") * 0.02, GROUP)
    if not layers:
        return w, w
    stack = QuantizedLinear4(
        q=torch.randint(0, 256, (layers, k // 2, n), generator=gen, device="cuda",
                        dtype=torch.uint8),
        s=(torch.rand((layers, k // GROUP, n), generator=gen, device="cuda") * 0.01).bfloat16(),
        zs=(torch.rand((layers, k // GROUP, n), generator=gen, device="cuda") * 0.05).bfloat16())
    for dst, src in zip(stack, w):
        dst[-1].copy_(src)
    return w, QuantizedLinear4(*(f[-1] for f in stack))


def gemm_agreement(out, ref, scale) -> dict:
    """Max |out - ref| and the largest share of the GEMM limit
    GEMM_ATOL * scale + rtol * |ref| any element uses (over 1 fails);
    ``err_per_roundoff`` is max |out - ref| / (2**-24 * scale)."""
    rtol = KERNEL_TOL[str(out.dtype)][1]
    diff = (out.float() - ref.float()).abs()
    share = diff / (GEMM_ATOL * scale + rtol * ref.float().abs() + 1e-30)
    return {"max_abs_err": diff.max().item(), "limit_share": share.max().item(),
            "err_per_roundoff": (diff / (2 ** -24 * scale + 1e-30)).max().item()}


def int4pack_yardstick(x, w):
    """torch._weight_int4pack_mm on the same nibbles (repacked, zero point
    8*s - zs), or None where the card's torch lacks it or refuses."""
    import torch

    from githubrepostorag_tpu_torch.ops.int4_matmul import dequant4

    try:
        k, n = w.q.shape[0] * 2, w.q.shape[1]
        gsz = k // w.s.shape[0]
        nib = dequant4(w.q, torch.ones_like(w.s), torch.zeros_like(w.zs), torch.float32)
        nib = nib.to(torch.int32).t().contiguous()  # [N, K] values 0..15
        packed = torch._convert_weight_to_int4pack(
            (nib[:, ::2] << 4 | nib[:, 1::2]).to(torch.uint8), 8)
        sz = torch.stack([w.s, (8 * w.s.float() - w.zs.float()).bfloat16()], dim=2).contiguous()
        x2 = x.reshape(-1, k)
        torch._weight_int4pack_mm(x2, packed, gsz, sz)
        return lambda: torch._weight_int4pack_mm(x2, packed, gsz, sz)
    except Exception as exc:  # noqa: BLE001 - a yardstick, not a check
        log(f"  torch._weight_int4pack_mm unavailable: {type(exc).__name__}: {str(exc)[:120]}")
        return None


def int4_plan(x, w):
    """The wrapper's plan of kernel D for bf16 ``x`` and weights ``w``."""
    from githubrepostorag_tpu_torch.device import sm_count
    from githubrepostorag_tpu_torch.ops import int4_matmul as ops

    m, k = x.numel() // x.shape[-1], x.shape[-1]
    n, n_g = w.q.shape[1], w.s.shape[0]
    return ops._plan_int4(m, k, n, k // n_g, x.data_ptr(), w.q.data_ptr(), w.s.data_ptr(),
                          w.zs.data_ptr(), sm_count(x.device))


def launch_plan(x, w, out, plan):
    """Kernel D through its C entry point with ``plan`` (no count): the
    block_m sweep of the kernel phase."""
    import torch

    from githubrepostorag_tpu_torch import kernels
    from githubrepostorag_tpu_torch.ops import int4_matmul as ops

    m, k = x.numel() // x.shape[-1], x.shape[-1]
    n, n_g = w.q.shape[1], w.s.shape[0]
    err = kernels.launcher("int4_matmul")(
        x.data_ptr(), w.q.data_ptr(), w.s.data_ptr(), w.zs.data_ptr(), out.data_ptr(), m, k, n,
        k // n_g, ops._DTYPES[x.dtype], ops._DTYPES[out.dtype], ops.LOADERS.index(plan.loader),
        plan.block_m, plan.grid, torch.cuda.current_stream().cuda_stream)
    kernels.check_launch("int4_matmul", err)


def measure_int4(x, w, w_view, out_dtype, timed: bool, sweep: bool = False) -> dict:
    """Kernel D (int4_matmul, w4a8=False) on ``w_view`` and ``w`` against
    int4_matmul_ref; both launches must take the loader of the wrapper's
    plan (``f32`` for float32 x).  Timed or ``sweep``: also every tile of x
    rows the plan could have taken, each held to int4_matmul_ref like the
    plan's (and timed when ``timed``)."""
    import torch

    from githubrepostorag_tpu_torch.ops.int4_matmul import dequant4, int4_matmul, int4_matmul_ref

    plan = int4_plan(x, w_view)
    loader = "f32" if x.dtype == torch.float32 else plan.loader
    before = dict(int4_matmul.launches_by_loader)
    out = int4_matmul(x, *w_view, out_dtype=out_dtype, w4a8=False)
    out_own = int4_matmul(x, *w, out_dtype=out_dtype, w4a8=False)
    took = {key: n - before[key] for key, n in int4_matmul.launches_by_loader.items()
            if n != before[key]}
    if took != {loader: 2}:
        raise RuntimeError(f"int4_matmul launches by loader {took}, expected {loader}: 2")
    ref = int4_matmul_ref(x, *w, out_dtype=out_dtype)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise RuntimeError("int4_matmul produced non-finite values")
    if not torch.equal(out, out_own):
        raise RuntimeError("int4_matmul differs between a stacked layer's view and its own copy")
    wq = dequant4(*w, x.dtype).float()
    res = gemm_agreement(out, ref, x.float().abs() @ wq.abs())
    res["loader"], res["block_m"] = loader, plan.block_m
    if not (timed or sweep) or loader == "f32":
        return res
    res["block_m_ms"], res["block_m_same_bits"] = {}, {}
    m, n = x.numel() // x.shape[-1], w.q.shape[1]
    scale = x.float().abs() @ wq.abs()
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    for bm in ((8,) if m <= 8 else (64, 128, 256)):
        tiles = -(-n // 128) * -(-m // bm)
        alt = plan._replace(block_m=bm, tiles=tiles, grid=min(tiles, n_sm))
        other = torch.empty_like(out)
        launch_plan(x, w_view, other, alt)
        torch.cuda.synchronize()
        if not gemm_agreement(other, ref, scale)["limit_share"] <= 1.0:
            raise RuntimeError(f"kernel D with block_m {bm} disagrees with int4_matmul_ref")
        res["block_m_same_bits"][bm] = torch.equal(other, out)
        if timed:
            res["block_m_ms"][bm] = time_ms(lambda: launch_plan(x, w_view, other, alt), 10)
    if not timed:
        return res
    m, k = x.numel() // x.shape[-1], x.shape[-1]
    n, n_g = w.q.shape[1], w.s.shape[0]
    res["ms"] = time_ms(lambda: int4_matmul(x, *w_view, out_dtype=out_dtype, w4a8=False), 10)
    res["plain_ms"] = time_ms(lambda: int4_matmul_ref(x, *w_view, out_dtype=out_dtype), 3, warmup=1)
    wb = wq.bfloat16()
    del wq
    res["library_ms"] = time_ms(lambda: torch.matmul(x, wb), 10)
    pack = int4pack_yardstick(x, w)
    res["library_int4pack_ms"] = time_ms(pack, 10) if pack else None
    out_bytes = 4 if out_dtype == torch.float32 else 2
    res["bound_ms"], res["bound_by"] = bound(
        2.0 * m * k * n, m * k * x.element_size() + k * n / 2 + 2 * n_g * n * 2 + m * n * out_bytes)
    return res


def dequant_bits(w, label: str) -> None:
    """Kernel D's dequantization bit for bit: with x the K x K identity in
    bf16 and f32 out, each output element is one product 1 * w[k, o]
    summed with zeros, so ``out`` must equal dequant4(q, s, zs, bf16)
    exactly, on every nibble and scale of ``w``."""
    import torch

    from githubrepostorag_tpu_torch.ops.int4_matmul import dequant4, int4_matmul

    k = w.q.shape[0] * 2
    eye = torch.eye(k, device="cuda", dtype=torch.bfloat16)
    out = int4_matmul(eye, *w, out_dtype=torch.float32, w4a8=False)
    want = dequant4(*w, torch.bfloat16).float()
    nibbles = torch.cat([w.q & 15, w.q >> 4]).unique().numel()
    if not torch.equal(out, want):
        bad = (out != want).sum().item()
        raise RuntimeError(f"kernel D's dequantization differs from dequant4 on {bad} weights "
                           f"({label})")
    log(f"kernel D dequantization bit for bit equal to dequant4 ({label}: {out.numel()} weights, "
        f"{nibbles} nibble values, {w.s.unique().numel()} scales, {int4_plan(eye, w).loader} "
        "loader)")


def w4a8_scale(x, w):
    """T of the W4A8 route: sxn[m] * sum_g (|s[g, o] * p[g, m, o]| +
    |R[m, g] * zs[g, o]|), the magnitudes of the group terms kernel E adds
    to its two accumulators (acc and zacc), taken 8 groups at a time."""
    import torch

    from githubrepostorag_tpu_torch.ops.int4_matmul import quantize_rows

    m, k = x.numel() // x.shape[-1], x.shape[-1]
    n, n_g = w.q.shape[1], w.s.shape[0]
    gsz = k // n_g
    xq, sxn = quantize_rows(x.reshape(m, k))
    xg = xq.reshape(m, n_g, gsz).transpose(0, 1).float()
    pg = w.q.reshape(n_g, gsz // 2, n)
    terms = xq.reshape(m, n_g, gsz).sum(-1).float().abs() @ w.zs.float().abs()
    for g in range(0, n_g, 8):
        nib = torch.cat([pg[g:g + 8] & 0xF, pg[g:g + 8] >> 4], dim=1).float()
        terms += (torch.bmm(xg[g:g + 8], nib).abs() * w.s[g:g + 8].float()[:, None, :]).sum(0)
    return (sxn * terms).reshape(*x.shape[:-1], n)


def prologue_bits(x, w, out_dtype):
    """Kernel E on ``w`` with its prologue checked bit for bit: the codes,
    sxn and R it wrote into the launch's workspace against quantize_rows
    and the int32 group sums of the same x.  Returns (out, plan)."""
    import torch

    from githubrepostorag_tpu_torch.ops import int4_matmul as ops

    m, k = x.numel() // x.shape[-1], x.shape[-1]
    n_g = w.s.shape[0]
    gsz = k // n_g
    out, ws, plan = ops._w4a8_launch(x, *w, out_dtype)
    torch.cuda.synchronize()
    xq, sxn, r = ops.w4a8_prologue_views(ws, plan, m, k, gsz)
    want_q, want_s = ops.quantize_rows(x.reshape(m, k))
    want_r = want_q.reshape(m, n_g, gsz).sum(-1, dtype=torch.int32)
    bad = {"codes": int((xq != want_q).sum()), "R": int((r != want_r).sum()),
           "sxn": int((sxn.view(torch.int32) != want_s.view(torch.int32)).sum())}
    if any(bad.values()):
        raise RuntimeError(f"kernel E's prologue differs from quantize_rows ({plan.kernel}, "
                           f"M={m} K={k} group {gsz}): {bad}")
    return out, plan


def tie_rows(k: int, gen):
    """Rows of x on exact .5 ties of x * 127 / amax (amax 127: the scale is
    1; amax 63.5: it is 2), an all-zero row, a row under the 1e-30 amax
    clamp, and random rows, float32 on the card."""
    import torch

    x = torch.randn((7, k), generator=gen, device="cuda")
    half = torch.randint(-126, 126, (2, k), generator=gen, device="cuda").float() + 0.5
    x[0], x[1] = half[0], half[1] / 2
    x[0, 0], x[1, 3], x[2] = 127.0, -63.5, 0.0
    x[3] *= 1e-31
    x[4] *= 1e4
    return x


def measure_w4a8(x, w, w_view, out_dtype, timed: bool) -> dict:
    """Kernel E (w4a8_matmul, the whole W4A8 route) on ``w_view`` with its
    prologue checked bit for bit, and on ``w``, against the plain route
    ``_w4a8(..., w4a8_matmul_ref)``; both launches must take the plan's
    kernel.  Timed: the route's device time (prologue and main kernel, by
    torch.profiler) as ``ms``, with CUDA events, the wrapper's host time,
    the plain route, the yardsticks, and the bound over the route's bytes
    (x, q, s, zs, out)."""
    import torch

    from githubrepostorag_tpu_torch.ops import int4_matmul as ops

    before = dict(ops.w4a8_matmul.launches_by_kernel)
    out, plan = prologue_bits(x, w_view, out_dtype)
    out_own = ops.w4a8_matmul(x, *w, out_dtype)
    took = {key: c - before[key] for key, c in ops.w4a8_matmul.launches_by_kernel.items()
            if c != before[key]}
    if took != {plan.kernel: 2}:
        raise RuntimeError(f"w4a8_matmul launches by kernel {took}, expected {plan.kernel}: 2")
    ref = ops._w4a8(x, *w, out_dtype, ops.w4a8_matmul_ref)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise RuntimeError("w4a8_matmul produced non-finite values")
    if not torch.equal(out, out_own):
        raise RuntimeError("w4a8_matmul differs between a stacked layer's view and its own copy")
    res = gemm_agreement(out, ref, w4a8_scale(x, w))
    res["kernel"], res["plan"] = plan.kernel, dict(plan._asdict(), loader=plan.loader)
    if not timed:
        return res
    m, k = x.numel() // x.shape[-1], x.shape[-1]
    n, n_g = w.q.shape[1], w.s.shape[0]
    fn = lambda: ops.w4a8_matmul(x, *w_view, out_dtype)  # noqa: E731
    wb = ops.dequant4(*w, x.dtype)
    res.update(device_timing(fn, lambda: torch.matmul(x, wb)))
    del wb
    res["prologue_us"] = sum(v for key, v in res["kernels_us"].items() if "prologue" in key)
    res["plain_ms"] = time_ms(lambda: ops._w4a8(x, *w_view, out_dtype, ops.w4a8_matmul_ref), 5,
                              warmup=1)
    pack = int4pack_yardstick(x, w)
    res["library_int4pack_ms"] = time_ms(pack, 50) if pack else None
    out_bytes = 4 if out_dtype == torch.float32 else 2
    res["bound_ms"], res["bound_by"] = bound(
        2.0 * m * k * n, m * k * x.element_size() + k * n / 2 + 2 * n_g * n * 2 + m * n * out_bytes,
        peak=PEAK_INT8_OPS)
    res["bound_share"] = res["bound_ms"] / res["ms"]
    return res


def w4a8_route_times(gen) -> dict:
    """w4a8_matmul at the 7B decode shapes (M = 8; wgu and wd also at M =
    64), bf16 x, random group-64 weights: the route's device time (every
    kernel it launches, torch.profiler), CUDA events and the wrapper's host
    time per call.  Uses only w4a8_matmul's signature, so it times another
    checkout's route too (copy this script there)."""
    import torch

    from githubrepostorag_tpu_torch.models.quant import quantize_weight4
    from githubrepostorag_tpu_torch.ops import int4_matmul as ops

    out = {}
    for name, ms in (("wqkv", (8,)), ("wo", (8,)), ("wgu", (8, 64)), ("wd", (8, 64)),
                     ("lm_head", (8,))):
        k, n = Q7B_SHAPES[name]
        w = quantize_weight4(torch.randn((k, n), generator=gen, device="cuda") * 0.02, GROUP)
        out_dtype = torch.float32 if name == "lm_head" else torch.bfloat16
        for m in ms:
            x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
            fn = lambda: ops.w4a8_matmul(x, *w, out_dtype)  # noqa: E731
            res = {"events_ms": time_ms(fn, 50)}
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            res["host_us"] = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
            res["kernels_us"] = device_us(fn)
            res["ms"] = sum(res["kernels_us"].values()) / 1e3
            out[f"{name}@M{m}"] = res
        del w
        torch.cuda.empty_cache()
    log(f"w4a8 route times: {json.dumps(out)}")
    return out


def phase_int4_kernels(rng) -> dict:
    """Kernels D and E against their plain versions at the 7B shapes, on
    the last layer of a 28-layer stack and on their own copy, and D at
    ragged shapes through both of its loaders."""
    import torch

    from githubrepostorag_tpu_torch.ops.int4_matmul import int4_matmul

    gen = torch.Generator(device="cuda")
    gen.manual_seed(int(rng.integers(1 << 30)))
    checks, results = [], {}

    def check(label, res):
        checks.append((label, res))
        log(f"{label}: {json.dumps(res)}")
        return res

    def randx(m, k, dtype):
        return torch.randn((m, k), generator=gen, device="cuda").to(dtype)

    # ragged small cases first: rows and columns off the tiles, group 128
    from githubrepostorag_tpu_torch.models.quant import quantize_weight4

    for k, n, m, gsz in ((256, 200, 5, 64), (512, 136, 3, 128)):
        w = quantize_weight4(torch.randn((k, n), generator=gen, device="cuda") * 0.02, gsz)
        for dtype in (torch.float32, torch.bfloat16):
            x = randx(m, k, dtype)
            check(f"kernel D small K={k} N={n} M={m} group {gsz} {str(dtype)[6:]}",
                  measure_int4(x, w, w, dtype, False))
            check(f"kernel E small K={k} N={n} M={m} group {gsz} {str(dtype)[6:]}",
                  measure_w4a8(x, w, w, dtype, False))
    # kernel E off the 7B path: group 256 (AutoAWQ checkpoints) and 128
    # (int32 partials across stages, 64 rows in two blocks of 32), N % 4 ==
    # 2 and odd N (the producer warp's own loads, a ragged last column
    # tile), rows past one block, and groups the route never sends (48, 16:
    # the CUDA-core kernel); then the prologue bit for bit on .5 ties, an
    # all-zero row and a row under the amax clamp
    from githubrepostorag_tpu_torch.ops import int4_matmul as ops
    for k, n, m, gsz in ((1024, 4608, 8, 256), (768, 202, 8, 256), (512, 202, 5, 64),
                         (512, 131, 8, 128), (512, 202, 77, 64), (1024, 4608, 64, 128),
                         (768, 256, 8, 48), (256, 200, 5, 16)):
        w = quantize_weight4(torch.randn((k, n), generator=gen, device="cuda") * 0.02, gsz)
        for dtype in (torch.float32, torch.bfloat16):
            res = check(f"kernel E K={k} N={n} M={m} group {gsz} {str(dtype)[6:]}",
                        measure_w4a8(randx(m, k, dtype), w, w, dtype, False))
            if res["kernel"] != ("mma" if (gsz // 2) % 32 == 0 else "dp4a"):
                raise RuntimeError(f"kernel E at group {gsz} took its {res['kernel']} kernel")
    for gsz in (64, 48):
        w = quantize_weight4(torch.randn((768, 256), generator=gen, device="cuda") * 0.02, gsz)
        for dtype in (torch.float32, torch.bfloat16):
            prologue_bits(tie_rows(768, gen).to(dtype), w, dtype)
    log("kernel E's prologue bit for bit equal to quantize_rows and the group sums (codes, sxn, "
        "R) on every case, .5 ties, an all-zero row and a row under the clamp included")
    # the route on the card, as the JAX package takes it on the chip: W4A8
    # (kernel E) for groups with (gsz // 2) % 32 == 0, kernel D otherwise
    for gsz in (32, 48, 64, 128, 256):
        w = quantize_weight4(torch.randn((768, 256), generator=gen, device="cuda") * 0.02, gsz)
        before = (ops.int4_matmul.launches, ops.w4a8_matmul.launches)
        int4_matmul(randx(8, 768, torch.bfloat16), *w)
        took = (ops.int4_matmul.launches - before[0], ops.w4a8_matmul.launches - before[1])
        want = (0, 1) if (gsz // 2) % 32 == 0 else (1, 0)
        if took != want:
            raise RuntimeError(f"int4_matmul at group {gsz}: (D, E) launches {took}, want {want}")
    log("int4 route on the card: groups 64, 128, 256 -> kernel E; 32, 48 -> kernel D")

    # kernel D's loaders off the 7B path: cp.async with N % 4 == 2 (2-byte q
    # copies) and with groups that are not a K step (48, 32), TMA with
    # ragged M and N tiles at group 128, and tiles of 64 and 128 rows
    for k, n, m, gsz in ((384, 202, 7, 48), (256, 72, 77, 32), (512, 272, 77, 128),
                         (512, 400, 300, 64), (256, 4608, 100, 64)):
        w = quantize_weight4(torch.randn((k, n), generator=gen, device="cuda") * 0.02, gsz)
        check(f"kernel D ragged K={k} N={n} M={m} group {gsz} bfloat16",
              measure_int4(randx(m, k, torch.bfloat16), w, w, torch.bfloat16, False, sweep=True))
        dequant_bits(w, f"K={k} N={n} group {gsz}")
    # the host's cost of a launch, with (TMA: four tensor maps encoded) and
    # without descriptors (cp.async), at a size where the device work is
    # negligible
    for n in (256, 200):
        w = quantize_weight4(torch.randn((256, n), generator=gen, device="cuda") * 0.02, 64)
        x = randx(8, 256, torch.bfloat16)
        fn = lambda: int4_matmul(x, *w, w4a8=False)  # noqa: E731
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            fn()
        host_us = (time.perf_counter() - t0) / 500 * 1e6
        torch.cuda.synchronize()
        log(f"kernel D host time per call, {int4_plan(x, w).loader} loader (M=8 K=256 N={n}): "
            f"{host_us:.2f} us")

    layers = 28
    d_rows = {"wqkv": (4096,), "wo": (4096,), "wgu": (512, 2048, 4096), "wd": (4096,),
              "lm_head": (8,)}
    for name in ("wqkv", "wo", "wgu", "wd", "lm_head"):
        k, n = Q7B_SHAPES[name]
        w, view = int4_case(gen, k, n, None if name == "lm_head" else layers)
        out_dtype = torch.float32 if name == "lm_head" else None
        if name == "wqkv":
            dequant_bits(view, "7B wqkv, the stacked layer's view")
        for m in (1, 8, 64, 256):
            for dtype in (torch.float32, torch.bfloat16):
                timed = dtype == torch.bfloat16 and m in (8, 64)
                res = check(f"kernel E {name} M={m} {str(dtype)[6:]}",
                            measure_w4a8(randx(m, k, dtype), w, view, out_dtype or dtype, timed))
                if res["kernel"] != "mma" or res["plan"]["loader"] != "tma":
                    raise RuntimeError(f"kernel E at 7B {name} took {res['kernel']} "
                                       f"{res['plan']['loader']}")
                if timed:
                    results[f"w4a8_matmul@{name}@M{m}"] = res
        for m in d_rows[name]:
            for dtype in (torch.float32, torch.bfloat16):
                timed = dtype == torch.bfloat16
                res = check(f"kernel D {name} M={m} {str(dtype)[6:]}",
                            measure_int4(randx(m, k, dtype), w, view, out_dtype or dtype, timed))
                if timed:
                    if res["loader"] != "tma":
                        raise RuntimeError(f"kernel D at 7B {name} took the {res['loader']} loader")
                    results[f"int4_matmul@{name}@M{m}"] = res
        del w, view
        torch.cuda.empty_cache()

    bad = [label for label, r in checks if not r["limit_share"] <= 1.0]
    worst = max(r["err_per_roundoff"] for _, r in checks)
    if bad:
        raise RuntimeError(f"int4 kernels and plain versions disagree beyond {GEMM_ATOL:g} * T + "
                           f"rtol |ref| (worst {worst:.3g} roundoff units of T): {bad}")
    log(f"kernels D and E agree with their plain versions element-wise within {GEMM_ATOL:g} * T "
        f"+ rtol |ref| (worst {worst:.3g} f32 roundoff units of T)")
    main = {"int4_matmul": results["int4_matmul@wgu@M4096"],
            "w4a8_matmul": results["w4a8_matmul@wgu@M8"]}
    for name, key in (("int4_matmul", "int4_matmul@"), ("w4a8_matmul", "w4a8_matmul@")):
        main[name] = dict(main[name], max_abs_err=max(
            r["max_abs_err"] for k, r in results.items() if k.startswith(key)))
    return {**main, **results}


def make_7b_params():
    import torch

    from githubrepostorag_tpu_torch.models.qwen2 import Qwen2Config, init_params
    from githubrepostorag_tpu_torch.models.quant import fuse_projections

    cfg = Qwen2Config.qwen2_7b()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    t0 = time.monotonic()
    params = fuse_projections(init_params(cfg, gen, device="cuda", dtype=torch.bfloat16),
                              in_place=True)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in [params["embed"], params["norm"], params["lm_head"],
                                *params["layers"].values()])
    log(f"Qwen2-7B random bf16 weights: {n / 1e9:.2f} B params in {time.monotonic() - t0:.1f} s")
    return cfg, params


def at_depth(cfg, params: dict, layers: int) -> tuple:
    """The model at its widths cut to its first ``layers`` layers: the
    config and a tree whose stacked layer tensors are views of ``params``'."""
    import dataclasses

    return (dataclasses.replace(cfg, num_layers=layers),
            {**params, "layers": {k: v[:layers] for k, v in params["layers"].items()}})


def upcast(params: dict) -> dict:
    """The tree with every plain float leaf in float32 (activations follow
    the final norm's dtype); quantized leaves stay as they are."""
    return {k: upcast(v) if isinstance(v, dict) else (v if isinstance(v, tuple) else v.float())
            for k, v in params.items()}


def rel(a, ref) -> float:
    return ((a - ref).norm() / ref.norm()).item()


def check_f32_logits(label, kern, plain) -> None:
    """Float32 logits, kernels vs plain path: relative error within
    LOGITS_RTOL_F32 and argmax equal wherever the top-2 margin exceeds the
    same share of the logits' rms."""
    err32 = rel(kern, plain)
    atol = LOGITS_RTOL_F32 * plain.pow(2).mean().sqrt().item()
    top2 = plain.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > atol
    agree = (kern.argmax(-1) == plain.argmax(-1))[decided]
    log(f"{label} f32 logits kernels vs plain: rel err {err32:.3g} (limit {LOGITS_RTOL_F32}); "
        f"argmax agrees at {int(agree.sum())}/{int(decided.sum())} positions whose top-2 margin "
        f"> {atol:.3g}")
    if err32 > LOGITS_RTOL_F32 or not bool(agree.all()):
        raise RuntimeError(f"{label} float32 logits with kernels disagree with the plain path")


def phase_model(cfg, params, label: str = "7B", p32=None) -> None:
    """forward_paged prefill logits, kernels against the plain path, at
    Qwen2-7B width and depth.  In float32 (plain float leaves upcast; int4
    leaves stay int4 and dequantize in f32) the two paths do the same
    arithmetic in another order, so they must agree tightly.  In bf16 both
    round at other places, and a random-weight 28-layer model amplifies
    that; there the kernel path must be no less accurate than the plain
    path, both measured against the float32 plain logits."""
    import torch

    from githubrepostorag_tpu_torch.models.qwen2 import forward_paged
    from githubrepostorag_tpu_torch.serving.kv_cache import make_page_pools, slot_mapping

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 1)
    b, s, ps = 2, 512, 128
    new = [512, 300]
    ids = np.zeros((b, s), dtype=np.int32)
    slots = np.full((b, s), -1, dtype=np.int32)
    # row 1's pages run to the pool's last page: its -1 padding slots must
    # be dropped, not written there
    bt = np.asarray([[0, 1, 2, 3], [7, 6, 5, 4]], dtype=np.int32)
    for i, n in enumerate(new):
        ids[i, :n] = rng.integers(0, cfg.vocab_size, n)
        slots[i] = slot_mapping(bt[i], 0, n, ps, s)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    args = (t(ids), t(pos))
    rest = (t(slots), t(bt), t(np.zeros(b, np.int32)), t(np.asarray(new, np.int32)))
    valid = torch.zeros((b, s), dtype=torch.bool, device=dev)
    for i, n in enumerate(new):
        valid[i, :n] = True

    def run(p, dtype, use_kernels):
        pools = make_page_pools(cfg, 8, ps, dtype=dtype, device=dev)
        t0 = time.monotonic()
        logits, _, _ = forward_paged(p, cfg, *args, pools.k, pools.v, *rest,
                                     use_kernels=use_kernels)
        torch.cuda.synchronize()
        log(f"forward_paged {label} [2, 512] {str(dtype)[6:]} use_kernels={use_kernels}: "
            f"{(time.monotonic() - t0) * 1e3:.1f} ms host wall")
        out = logits[valid]  # [valid positions, V]
        if not torch.isfinite(out).all():
            raise RuntimeError(f"non-finite {label} logits")
        return out

    bf_kern = run(params, torch.bfloat16, True)
    bf_plain = run(params, torch.bfloat16, False)
    p32 = upcast(params) if p32 is None else p32
    f_kern = run(p32, torch.float32, True)
    f_plain = run(p32, torch.float32, False)
    del p32

    check_f32_logits(f"{label} forward_paged", f_kern, f_plain)
    e_kern, e_plain = rel(bf_kern, f_plain), rel(bf_plain, f_plain)
    log(f"{label} bf16 logits vs f32 plain: kernels {e_kern:.3g}, plain {e_plain:.3g}; "
        f"kernels vs plain {rel(bf_kern, bf_plain):.3g}")
    if e_kern > LOGITS_BF16_SLACK * e_plain:
        raise RuntimeError(f"{label} bf16 forward_paged with kernels is less accurate than the "
                           "plain path")


def _packed_wave(cfg, rng, dev):
    """The kernel-C-shaped packed wave at 7B: a [1, 2048] buffer of five
    segments (new 512, 512, 300, 500, 100 at cached 0, 1024, 2500, 0,
    3000) and 124 padding tokens, in a row bucket of 8 (three empty
    segments, as the engine pads five rows); shuffled block tables."""
    import torch

    from githubrepostorag_tpu_torch.serving.kv_cache import packed_slot_mapping

    ps, budget, rb, tq = 128, 2048, 8, 512
    cached, new = [0, 1024, 2500, 0, 3000], [512, 512, 300, 500, 100]
    total = [c + n for c, n in zip(cached, new)]
    max_pages = -(-max(total) // ps)
    bt5, num_pages = _shuffled_tables(rng, total, ps, max_pages, spare=4)
    bt = np.zeros((rb, max_pages), np.int32)
    bt[:5] = bt5
    ids = np.zeros((1, budget), np.int32)
    pos = np.zeros((1, budget), np.int32)
    seg = np.full((budget,), rb, np.int32)
    slots = np.full((budget,), -1, np.int32)
    logits_at = np.zeros((rb,), np.int32)
    cached_a, new_a = np.zeros(rb, np.int32), np.zeros(rb, np.int32)
    off = 0
    for r, (c, n) in enumerate(zip(cached, new)):
        ids[0, off:off + n] = rng.integers(0, cfg.vocab_size, n)
        pos[0, off:off + n] = np.arange(c, c + n)
        seg[off:off + n] = r
        packed_slot_mapping(bt[r], c, n, ps, slots, off)
        logits_at[r] = off + n - 1
        cached_a[r], new_a[r] = c, n
        off += n
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    args = [t(ids), t(pos)]
    rest = [t(slots), t(bt), t(cached_a), t(new_a), t(seg), t(logits_at), tq]
    return args, rest, num_pages, ps, t(slots[slots >= 0]).long()


def phase_packed_model(cfg, params, p32) -> None:
    """forward_paged_packed logits (and the last layer's committed K) on
    the packed wave, kernels (C) against the plain path, by phase_model's
    rules.  The cached context the wave resumes is random K/V, the same for
    both paths."""
    import torch

    from githubrepostorag_tpu_torch.models.qwen2 import forward_paged_packed
    from githubrepostorag_tpu_torch.serving.kv_cache import make_page_pools

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 5)
    args, rest, num_pages, ps, live_slots = _packed_wave(cfg, rng, dev)
    gen = torch.Generator(device=dev)

    def run(p, dtype, use_kernels):
        pools = make_page_pools(cfg, num_pages, ps, dtype=dtype, device=dev)
        gen.manual_seed(SEED + 6)
        pools.k.normal_(generator=gen)
        pools.v.normal_(generator=gen)
        t0 = time.monotonic()
        logits, kp, _ = forward_paged_packed(p, cfg, *args, pools.k, pools.v, *rest,
                                             use_kernels=use_kernels)
        torch.cuda.synchronize()
        log(f"forward_paged_packed 7B [1, 2048] R=5 {str(dtype)[6:]} use_kernels={use_kernels}: "
            f"{(time.monotonic() - t0) * 1e3:.1f} ms host wall")
        out = logits[:5, 0]
        k_last = kp[-1].reshape(cfg.num_kv_heads, -1, cfg.head_dim)[:, live_slots].float()
        if not (torch.isfinite(out).all() and torch.isfinite(k_last).all()):
            raise RuntimeError("non-finite packed prefill logits or K")
        return out, k_last

    bf_kern, _ = run(params, torch.bfloat16, True)
    bf_plain, _ = run(params, torch.bfloat16, False)
    f_kern, fk_kern = run(p32, torch.float32, True)
    f_plain, fk_plain = run(p32, torch.float32, False)
    check_f32_logits("7B forward_paged_packed", f_kern, f_plain)
    e_k = rel(fk_kern, fk_plain)
    log(f"7B forward_paged_packed f32 layer-27 K of the 1924 live tokens, kernels vs plain: "
        f"rel err {e_k:.3g} (limit {LOGITS_RTOL_F32})")
    if e_k > LOGITS_RTOL_F32:
        raise RuntimeError("7B packed prefill K with kernels disagrees with the plain path")
    e_kern, e_plain = rel(bf_kern, f_plain), rel(bf_plain, f_plain)
    log(f"7B forward_paged_packed bf16 logits vs f32 plain: kernels {e_kern:.3g}, plain "
        f"{e_plain:.3g}")
    if e_kern > LOGITS_BF16_SLACK * e_plain:
        raise RuntimeError("bf16 forward_paged_packed with kernels is less accurate than the "
                           "plain path")


def phase_quant_pools_model(cfg, p32) -> None:
    """forward_paged with int8 and with int4 KV pages, float32 activations:
    each quantized path (kernel A's branch, and the plain path) measured
    against the plain path over full-precision pools.  The kernel path's
    error may exceed the plain quantized path's by LOGITS_BF16_SLACK at
    most: a step of one int8 code upstream (two correct summation orders
    either side of a rounding boundary) makes an element-wise gate on the
    whole model unsound, so the kernel phase holds the branches element by
    element."""
    import torch

    from githubrepostorag_tpu_torch.models.qwen2 import forward_paged
    from githubrepostorag_tpu_torch.serving.kv_cache import make_page_pools, slot_mapping

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 1)
    b, s, ps = 2, 512, 128
    new = [512, 300]
    ids = np.zeros((b, s), dtype=np.int32)
    slots = np.full((b, s), -1, dtype=np.int32)
    bt = np.asarray([[0, 1, 2, 3], [7, 6, 5, 4]], dtype=np.int32)
    for i, n in enumerate(new):
        ids[i, :n] = rng.integers(0, cfg.vocab_size, n)
        slots[i] = slot_mapping(bt[i], 0, n, ps, s)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    rest = (t(slots), t(bt), t(np.zeros(b, np.int32)), t(np.asarray(new, np.int32)))
    valid = torch.zeros((b, s), dtype=torch.bool, device=dev)
    for i, n in enumerate(new):
        valid[i, :n] = True

    def run(quant, use_kernels):
        pools = make_page_pools(cfg, 8, ps, dtype=torch.float32, device=dev, quant=quant)
        out = forward_paged(p32, cfg, t(ids), t(pos), pools.k, pools.v, *rest,
                            use_kernels=use_kernels, k_scales=pools.ks, v_scales=pools.vs)
        torch.cuda.synchronize()
        logits = out[0][valid]
        if not torch.isfinite(logits).all():
            raise RuntimeError(f"non-finite logits over int{quant} pages")
        return logits

    ref = run(0, False)
    for quant in (8, 4):
        e_kern, e_plain = rel(run(quant, True), ref), rel(run(quant, False), ref)
        log(f"7B forward_paged f32 over int{quant} KV pages vs full-precision pages: kernel A "
            f"int{quant} path {e_kern:.3g}, plain path {e_plain:.3g}")
        if e_kern > LOGITS_BF16_SLACK * e_plain:
            raise RuntimeError(f"kernel A's int{quant} path is less accurate than the plain path")


def quantize_7b(params) -> dict:
    """The bf16 7B tree quantized to group-wise int4 on the card, one layer
    at a time (varied scales, unlike init_params_quantized's constant
    ones); the embedding table goes per-row int8."""
    import torch

    from githubrepostorag_tpu_torch.models.quant import params_nbytes, quantize_qwen2_params

    t0 = time.monotonic()
    qparams = quantize_qwen2_params(params, bits=4, group_size=GROUP)
    torch.cuda.synchronize()
    log(f"Qwen2-7B int4 (group {GROUP}) weights: {params_nbytes(qparams) / 1e9:.2f} GB "
        f"(bf16 tree {params_nbytes(params) / 1e9:.2f} GB), quantized in "
        f"{time.monotonic() - t0:.1f} s")
    return qparams


def phase_decode_logits(cfg, params) -> None:
    """Kernel E's model-level gate: one decode step (8 rows of one token,
    the automatic int4 route, so every projection and the lm_head run
    W4A8) in float32 through the plain versions, with kernel E's route run
    beside every one of its 113 matmuls on the same activations and held to
    the element-wise GEMM limit.  The two paths are not compared free
    running: the per-row int8 activation quantization is discontinuous, so
    an f32 summation-order difference that moves an activation across a
    rounding boundary changes it by a whole int8 step, and 28 random layers
    amplify that (2e-2 relative in the logits on an H100); that drift is
    printed, not gated."""
    import torch

    from githubrepostorag_tpu_torch.models import quant
    from githubrepostorag_tpu_torch.models.qwen2 import forward
    from githubrepostorag_tpu_torch.ops.int4_matmul import int4_matmul

    rng = np.random.default_rng(SEED + 4)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 1)).astype(np.int32)).cuda()
    pos = torch.from_numpy(rng.integers(0, 4096, (8, 1)).astype(np.int32)).cuda()
    p32 = upcast(params)
    plain_fn, checks = quant.int4_matmul_plain, []

    def checked(x, q, s, zs, out_dtype=None, w4a8=None):
        ref = plain_fn(x, q, s, zs, out_dtype=out_dtype, w4a8=w4a8)
        out = int4_matmul(x, q, s, zs, out_dtype=out_dtype, w4a8=w4a8)
        checks.append(gemm_agreement(out, ref, w4a8_scale(x, quant.QuantizedLinear4(q, s, zs))))
        return ref

    launches = int4_matmul.launches
    quant.int4_matmul_plain = checked
    try:
        plain, _ = forward(p32, cfg, ids, pos, use_kernels=False)
    finally:
        quant.int4_matmul_plain = plain_fn
    kern, _ = forward(p32, cfg, ids, pos)
    torch.cuda.synchronize()
    if not (torch.isfinite(kern).all() and torch.isfinite(plain).all()):
        raise RuntimeError("non-finite decode logits")
    want = 4 * cfg.num_layers + 1
    worst = max(c["limit_share"] for c in checks)
    log(f"7B int4 decode step: {len(checks)} W4A8 matmuls on the model's activations, kernel E's "
        f"route vs plain: worst share of the GEMM limit {worst:.3g}, max abs err "
        f"{max(c['max_abs_err'] for c in checks):.3g}")
    if len(checks) != want or int4_matmul.launches != launches or not worst <= 1.0:
        raise RuntimeError(f"7B int4 decode step: {len(checks)} of {want} matmuls checked, "
                           f"{int4_matmul.launches - launches} took kernel D, worst share {worst}")
    top2 = plain[:, 0].topk(2, dim=-1).values
    log(f"7B int4 decode step free running, kernels vs plain: rel err {rel(kern, plain):.3g}, "
        f"argmax equal on {int((kern[:, 0].argmax(-1) == plain[:, 0].argmax(-1)).sum())}/8 rows "
        f"(top-2 margins {[round(x, 4) for x in (top2[:, 0] - top2[:, 1]).tolist()]})")


def _prefill_logits(params, cfg, seed: int):
    """forward_paged logits of a padded [2, 256] prefill wave (row 1 has
    200 real tokens) over fresh bf16 pools: [valid positions, V] f32."""
    import torch

    from githubrepostorag_tpu_torch.models.qwen2 import forward_paged
    from githubrepostorag_tpu_torch.serving.kv_cache import make_page_pools, slot_mapping

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    b, s, ps, new = 2, 256, 128, [256, 200]
    ids = np.zeros((b, s), dtype=np.int32)
    slots = np.full((b, s), -1, dtype=np.int32)
    bt = np.asarray([[0, 1], [3, 2]], dtype=np.int32)
    for i, n in enumerate(new):
        ids[i, :n] = rng.integers(0, cfg.vocab_size, n)
        slots[i] = slot_mapping(bt[i], 0, n, ps, s)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    pools = make_page_pools(cfg, 4, ps, dtype=torch.bfloat16, device=dev)
    logits, _, _ = forward_paged(params, cfg, t(ids), t(pos), pools.k, pools.v, t(slots), t(bt),
                                 t(np.zeros(b, np.int32)), t(np.asarray(new, np.int32)))
    valid = torch.zeros((b, s), dtype=torch.bool, device=dev)
    for i, n in enumerate(new):
        valid[i, :n] = True
    return logits[valid]


def hf_state_dict(params: dict, cfg) -> dict:
    """An unfused param tree in a HuggingFace Qwen2 (or, with experts,
    Qwen2-MoE) checkpoint's names and [out, in] layout (the inverse of
    hf_loader.params_from_state_dict)."""
    layers = params["layers"]
    sd = {"model.embed_tokens.weight": params["embed"], "model.norm.weight": params["norm"],
          "lm_head.weight": params["lm_head"].t()}
    names = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj", "wv": "self_attn.v_proj",
             "wo": "self_attn.o_proj"}
    if cfg.num_experts:
        names.update({"router": "mlp.gate", "s_wg": "mlp.shared_expert.gate_proj",
                      "s_wu": "mlp.shared_expert.up_proj", "s_wd": "mlp.shared_expert.down_proj",
                      "s_gate": "mlp.shared_expert_gate"})
    else:
        names.update({"wg": "mlp.gate_proj", "wu": "mlp.up_proj", "wd": "mlp.down_proj"})
    experts = {"e_wg": "gate_proj", "e_wu": "up_proj", "e_wd": "down_proj"}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        for key, name in names.items():
            sd[p + name + ".weight"] = layers[key][i].t()
        for e in range(cfg.num_experts):
            for key, name in experts.items():
                sd[p + f"mlp.experts.{e}.{name}.weight"] = layers[key][i, e].t()
        for key, name in (("bq", "q_proj"), ("bk", "k_proj"), ("bv", "v_proj")):
            sd[p + f"self_attn.{name}.bias"] = layers[key][i]
        sd[p + "input_layernorm.weight"] = layers["ln1"][i]
        sd[p + "post_attention_layernorm.weight"] = layers["ln2"][i]
    return sd


def write_checkpoint(root, params, cfg) -> int:
    """``params`` as a Hugging Face Qwen2 (or Qwen2-MoE) checkpoint in
    ``root`` (the port's safetensors writer, config.json); returns the
    weights' bytes."""
    from githubrepostorag_tpu_torch.models.safetensors_io import save_file

    save_file(hf_state_dict(params, cfg), root / "model.safetensors")
    (root / "config.json").write_text(json.dumps({
        "model_type": "qwen2", "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size, "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads, "num_key_value_heads": cfg.num_kv_heads,
        "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_norm_eps,
        "max_position_embeddings": cfg.max_position_embeddings,
        "tie_word_embeddings": False, "torch_dtype": "bfloat16",
        **({"model_type": "qwen2_moe", "num_experts": cfg.num_experts,
            "num_experts_per_tok": cfg.num_experts_per_tok,
            "moe_intermediate_size": cfg.moe_intermediate_size,
            "shared_expert_intermediate_size": cfg.shared_expert_intermediate_size,
            "norm_topk_prob": cfg.norm_topk_prob, "decoder_sparse_step": 1,
            "mlp_only_layers": []} if cfg.num_experts else {})}))
    return (root / "model.safetensors").stat().st_size


def write_byte_tokenizer(root, vocab_size: int) -> None:
    """A byte-level BPE ``tokenizer.json`` with no merges (the 256 byte
    tokens) and Qwen2's three ChatML specials at the top of the vocab, for
    a checkpoint an entry point loads with ``make_tokenizer``."""
    from githubrepostorag_tpu_torch.serving.bpe_native import _byte_to_unicode

    b2u = _byte_to_unicode()
    specials = ["<|endoftext|>", "<|im_start|>", "<|im_end|>"]
    first = min(151643, vocab_size - len(specials))
    (root / "tokenizer.json").write_text(json.dumps({
        "model": {"type": "BPE", "vocab": {b2u[b]: b for b in range(256)}, "merges": []},
        "added_tokens": [{"id": first + i, "content": t, "special": True}
                         for i, t in enumerate(specials)],
        "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False, "use_regex": True},
    }))
    (root / "tokenizer_config.json").write_text(json.dumps({"eos_token": "<|im_end|>"}))


def phase_load() -> dict:
    """A full-width Qwen2-7B checkpoint cut to 2 layers (depth cut only to
    keep the write short), random bf16 weights from the seed, written with
    the port's save_file and loaded back with load_qwen2 onto the card:
    every tensor equal to the one written, forward_paged logits equal bit
    for bit to those of the same tensors built in memory; loaded again with
    quantize=4, whose prefill runs kernel D."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from githubrepostorag_tpu_torch import kernels
    from githubrepostorag_tpu_torch.models.hf_loader import load_qwen2
    from githubrepostorag_tpu_torch.models.quant import fuse_projections
    from githubrepostorag_tpu_torch.models.qwen2 import Qwen2Config

    cfg, params = load_phase_tree()
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="ckpt-", dir=kernels.BUILD_DIR))
    stats = {}
    try:
        t0 = time.monotonic()
        nbytes = write_checkpoint(root, params, cfg)
        stats["checkpoint_gb"] = nbytes / 1e9
        stats["write_s"] = time.monotonic() - t0

        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        loaded, lcfg = load_qwen2(root, dtype=torch.bfloat16, fuse=True, device="cuda")
        torch.cuda.synchronize()
        stats["load_s"] = time.monotonic() - t0
        stats["load_gb_s"] = nbytes / 1e9 / stats["load_s"]
        # the load's own device peak, over the checkpoint's bytes; at full
        # depth the same ratio of the 28-layer checkpoint is an estimate
        peak = torch.cuda.max_memory_allocated() - base
        stats["load_peak_gb"] = peak / 1e9
        stats["load_peak_over_checkpoint"] = peak / nbytes
        full = Qwen2Config.qwen2_7b()
        layer_bytes = sum(t.numel() * t.element_size() for k, t in hf_state_dict(params, cfg).items()
                          if k.startswith("model.layers.")) / cfg.num_layers
        stats["full_depth_checkpoint_gb"] = (
            nbytes + (full.num_layers - cfg.num_layers) * layer_bytes) / 1e9
        stats["full_depth_load_peak_gb_est"] = (stats["load_peak_over_checkpoint"]
                                                * stats["full_depth_checkpoint_gb"])
        if lcfg != cfg:
            raise RuntimeError(f"loaded config {lcfg} differs from the written {cfg}")
        want = fuse_projections(params)
        flat = lambda tree: {**{k: v for k, v in tree.items() if k != "layers"},  # noqa: E731
                             **{f"layers.{k}": v for k, v in tree["layers"].items()}}
        got, exp = flat(loaded), flat(want)
        if sorted(got) != sorted(exp):
            raise RuntimeError(f"loaded keys {sorted(got)} differ from {sorted(exp)}")
        bad = [k for k in exp if not (got[k].dtype == exp[k].dtype and torch.equal(got[k], exp[k]))]
        if bad:
            raise RuntimeError(f"loaded tensors differ from the written ones: {bad}")
        if not torch.equal(_prefill_logits(loaded, cfg, SEED + 10),
                           _prefill_logits(want, cfg, SEED + 10)):
            raise RuntimeError("forward_paged logits of the loaded tree differ from the "
                               "in-memory tree's")
        del loaded, want, got, exp
        torch.cuda.empty_cache()

        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        qparams, _ = load_qwen2(root, dtype=torch.bfloat16, quantize=4, fuse=True, device="cuda")
        torch.cuda.synchronize()
        stats["load_int4_s"] = time.monotonic() - t0
        stats["load_int4_peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
        reset_launches()
        logits = _prefill_logits(qparams, cfg, SEED + 10)
        torch.cuda.synchronize()
        stats["int4_launches"] = read_launches()["int4_matmul"]
        if stats["int4_launches"] <= 0 or not torch.isfinite(logits).all():
            raise RuntimeError(f"int4 prefill of the loaded checkpoint: {stats['int4_launches']} "
                               "kernel D launches, finite logits "
                               f"{bool(torch.isfinite(logits).all())}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"load: full-width 2-layer Qwen2-7B checkpoint {stats['checkpoint_gb']:.2f} GB written in "
        f"{stats['write_s']:.1f} s, loaded onto the card in {stats['load_s']:.2f} s "
        f"({stats['load_gb_s']:.2f} GB/s), every tensor and the prefill logits equal bit for bit; "
        f"device peak of the load {stats['load_peak_gb']:.3f} GB "
        f"({stats['load_peak_over_checkpoint']:.3f}x the checkpoint; at full depth, "
        f"{stats['full_depth_checkpoint_gb']:.2f} GB, that ratio gives "
        f"{stats['full_depth_load_peak_gb_est']:.2f} GB, an estimate); "
        f"loaded with quantize=4 in {stats['load_int4_s']:.2f} s "
        f"(peak {stats['load_int4_peak_gb']:.3f} GB), prefill through kernel D "
        f"({stats['int4_launches']} launches)")
    return stats


# ------------------------------------------------------------- retrieval --

# the encoder's float32 rate: the H100 SXM data sheet's figure outside the
# tensor cores (the encoder runs IEEE float32, no TF32)
PEAK_F32_FLOPS = 67e12
RETRIEVAL_TABLE = "embeddings"  # EMBEDDINGS_TABLE_CHUNK's default: the chunk scope's table
RETRIEVAL_TOL = 1e-5  # index vs host store: scores; ids in order across every clearer gap
ENCODER_TOL = 1e-4  # card float32 vs CPU float64, every component
COSINE_FLOOR = 1 - 1e-6
PAD_TOL = 1e-6  # real rows' vectors with and without padded rows beside them
_IDENTS = ("index", "store", "query", "vector", "node", "tree", "parse", "token", "batch", "page",
           "cache", "engine", "request", "result", "config", "worker", "stream", "shard", "table",
           "score", "filter", "scope", "repo", "module", "chunk", "embed", "decode", "prefill")


def percentile(xs, q: float) -> float:
    """Nearest-rank percentile of ``xs``."""
    s = sorted(xs)
    return s[min(len(s) - 1, int(q * len(s)))]


class SmokeTokenizer:
    """A deterministic stdlib stand-in for a BERT WordPiece tokenizer (the
    card's machine has no vocabulary file and may lack transformers):
    [CLS] + word pieces of at most 4 characters + [SEP], truncated to
    ``max_length``; a piece's id is its crc32 over the vocabulary's
    non-special range.  Called as the HF tokenizers are by the encoder.
    It is Python and far slower than a compiled tokenizer, so it keeps what
    it tokenised: a timed ``encode`` of texts tokenised before times the
    encoder, not this stand-in."""

    def __init__(self, vocab_size: int) -> None:
        self.vocab_size = vocab_size
        self._seen: dict[tuple[str, int], list[int]] = {}

    def ids(self, text: str, max_length: int) -> list[int]:
        import re
        import zlib

        key = (text, max_length)
        if key in self._seen:
            return self._seen[key]
        out = [101]
        for word in re.findall(r"\w+|[^\w\s]", text.lower()):
            for i in range(0, len(word), 4):
                out.append(1000 + zlib.crc32(word[i:i + 4].encode()) % (self.vocab_size - 1000))
        self._seen[key] = out = out[: max_length - 1] + [102]
        return out

    def __call__(self, texts, truncation=True, max_length=512, padding=False):
        return {"input_ids": [self.ids(t, max_length) for t in texts]}


def code_passages(rng, n: int) -> list[str]:
    """Synthetic code chunks: Python-like functions of 1-60 body lines
    (geometric, mean 10), so their token lengths (and the encoder's length
    buckets) span 32 to 512."""
    out = []
    for i in range(n):
        name = "_".join(rng.choice(_IDENTS, 2))
        lines = [f"def {name}_{i}(self, {rng.choice(_IDENTS)}, limit={int(rng.integers(1, 999))}):"]
        for _ in range(min(60, int(rng.geometric(0.1)))):
            a, b, c = rng.choice(_IDENTS, 3)
            lines.append(f"    {a} = self.{b}.{c}({a}, {int(rng.integers(0, 99))})  # {b} {c}")
        lines.append(f"    return {rng.choice(_IDENTS)}")
        out.append("\n".join(lines))
    return out


def chunk_metadata(row: int) -> dict:
    """The hierarchy's scope keys of chunk ``row``: 128 repositories of 2048
    chunks, 8 modules of 256 chunks a repository, 8 chunks a file."""
    repo, module = f"repo{row // 2048}", f"repo{row // 2048}/mod{row // 256 % 8}"
    return {"namespace": "default", "repo": repo, "module": module,
            "file_path": f"{module}/file{row // 8 % 32}.py"}


def same_ranking(host, dev, tol: float = RETRIEVAL_TOL) -> None:
    """Raise unless ``dev`` ranks as ``host`` does: the same length, scores
    within ``tol`` element by element, and the same ids before every gap
    between adjacent host scores wider than ``tol`` (ids inside a run of
    scores closer than ``tol`` may come in another order)."""
    hs, ds = [h.score for h in host], [h.score for h in dev]
    hi, di = [h.doc.doc_id for h in host], [h.doc.doc_id for h in dev]
    if len(hi) != len(di):
        raise RuntimeError(f"{len(di)} hits, the host store gave {len(hi)}")
    if hs and max(abs(a - b) for a, b in zip(hs, ds)) > tol:
        raise RuntimeError(f"scores differ beyond {tol}: {hs} vs {ds}")
    for i in range(len(hi)):
        clear = i + 1 == len(hi) or hs[i] - hs[i + 1] > tol
        if clear and set(hi[: i + 1]) != set(di[: i + 1]):
            raise RuntimeError(f"ids differ before a clear gap at {i}: {hi} vs {di}")


def encoder_check(enc, params, cfg, gen) -> dict:
    """``embed`` on the card (with allow_tf32 switched on around it: the
    encoder itself must hold IEEE float32) against the plain path on the
    CPU in float64, 3 real rows in a row bucket of 8 at every length bucket
    up to 512; the same 3 rows alone must give the same vectors."""
    import torch

    from githubrepostorag_tpu_torch.models.encoder import embed

    p64 = {k: ({kk: vv.double().cpu() for kk, vv in v.items()} if isinstance(v, dict)
               else v.double().cpu()) for k, v in params.items()}
    worst = {"max_abs_err": 0.0, "min_cosine": 1.0, "pad_max_abs": 0.0}
    for length in enc.length_buckets():
        ids = torch.randint(1000, cfg.vocab_size, (8, length), generator=gen, device=gen.device)
        mask = torch.zeros(8, length, dtype=torch.int64, device=gen.device)
        for row, n in enumerate((length, length // 2 + 1, 1)):
            mask[row, :n] = 1
        mask[3:, :3] = 1  # padded rows of the bucket, with a few tokens each
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            with torch.inference_mode():
                card = embed(params, cfg, ids.to(enc.device), mask.to(enc.device))
                alone = embed(params, cfg, ids[:3].to(enc.device), mask[:3].to(enc.device))
            if enc.device.type == "cuda":
                torch.cuda.synchronize()
            if torch.backends.cuda.matmul.allow_tf32 is not True:
                raise RuntimeError("the encoder did not restore the caller's allow_tf32")
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
        ref = embed(p64, cfg, ids[:3].cpu(), mask[:3].cpu())
        got = card[:3].double().cpu()
        err = (got - ref).abs().max().item()
        cos = torch.nn.functional.cosine_similarity(got, ref, dim=-1).min().item()
        pad = (card[:3] - alone).abs().max().item()
        if not torch.isfinite(card).all() or err > ENCODER_TOL or cos < COSINE_FLOOR or pad > PAD_TOL:
            raise RuntimeError(f"encoder at length {length}: max |card - f64| {err}, "
                               f"min cosine {cos}, padded rows moved real rows by {pad}")
        worst = {"max_abs_err": max(worst["max_abs_err"], err),
                 "min_cosine": min(worst["min_cosine"], cos),
                 "pad_max_abs": max(worst["pad_max_abs"], pad)}
    return worst


def encoder_flops(lengths, cfg) -> float:
    """The operations ``lengths`` need (real tokens only): per token the
    projections and FFN, 2 (4 d^2 + 2 d ff) a layer, plus attention over its
    own sequence, 4 n d a layer."""
    d, ff, layers = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    return sum(n * layers * (2 * (4 * d * d + 2 * d * ff) + 4 * n * d) for n in lengths)


def phase_retrieval(device: str = "cuda", cfg=None, rows: int = 258048, passages: int = 8192,
                    threads: int = 16, per_thread: int = 16, churn_ops: int = 800,
                    keep: dict | None = None) -> dict:
    """The retrieval path on the card at e5-small's published widths (random
    float32 weights from the seed) and an index of ``rows`` chunks (126
    repositories of 2048: the 262,144-row capacity bucket, 402.7 MB of
    corpus on the card): encoder checks and throughput, index parity with
    the host store (ties, filters, the fallback), coalesced retrieval
    through RetrieverFactory, a live-index churn with queries running, and
    a snapshot round trip.  No kernel of A-F may launch.  ``keep``, when
    given, receives the index and the encoder (the rag phase's store)."""
    import shutil
    import tempfile
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from githubrepostorag_tpu_torch import config, kernels
    from githubrepostorag_tpu_torch.embedding import TorchBertTextEncoder
    from githubrepostorag_tpu_torch.ingest.stream import MutationLog
    from githubrepostorag_tpu_torch.metrics import (
        DEVICE_INDEX_SEARCHES, RETRIEVAL_WAVE_SIZE, counter_value, histogram_stats)
    from githubrepostorag_tpu_torch.models.encoder import BertConfig, init_params
    from githubrepostorag_tpu_torch.retrieval import (
        DeviceIndexedStore, LiveIndexApplier, RetrieverFactory, restore_replica, save_snapshot)
    from githubrepostorag_tpu_torch.store.base import Doc
    from githubrepostorag_tpu_torch.store.memory import MemoryVectorStore
    from githubrepostorag_tpu_torch.utils import next_bucket

    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    cfg = cfg or BertConfig.e5_small()
    stats: dict = {}
    reset_launches()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t_phase = time.monotonic()
    rng = np.random.default_rng(SEED + 21)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 21)

    # -- encoder ---------------------------------------------------------
    params = init_params(cfg, gen, device=dev)
    tok = SmokeTokenizer(cfg.vocab_size)
    enc = TorchBertTextEncoder(params, cfg, tok, device=dev, max_length=cfg.max_position_embeddings)
    stats["encoder_check"] = encoder_check(enc, params, cfg, gen)
    t0 = time.monotonic()
    stats["encoder_warmup_shapes"] = enc.warmup()
    sync()
    stats["encoder_warmup_s"] = time.monotonic() - t0
    texts = code_passages(rng, passages)
    t0 = time.monotonic()
    lengths = [len(x) for x in tok([("passage: " + t) for t in texts],
                                   max_length=enc.max_length)["input_ids"]]
    tokenize_s = time.monotonic() - t0
    shapes0 = set(enc.shapes)
    t0 = time.monotonic()
    vecs = enc.encode(texts, kind="passage")
    sync()
    wall = time.monotonic() - t0
    if enc.shapes != shapes0:
        raise RuntimeError(f"encode met shapes warmup did not drive: {enc.shapes - shapes0}")
    if vecs.shape != (passages, cfg.hidden_size) or not np.isfinite(vecs).all():
        raise RuntimeError(f"passage vectors {vecs.shape}, finite {np.isfinite(vecs).all()}")
    if np.abs(np.linalg.norm(vecs, axis=1) - 1).max() > 1e-5:
        raise RuntimeError("passage vectors are not unit length")
    flops = encoder_flops(lengths, cfg)
    buckets = {b: 0 for b in enc.length_buckets()}
    for n in lengths:
        buckets[min(b for b in buckets if b >= n)] += 1
    queries_text = [t.splitlines()[1].strip() for t in texts[: threads * per_thread]]
    lat = []
    for q in queries_text[:60]:
        t0 = time.monotonic()
        enc.encode([q], kind="query")
        lat.append(time.monotonic() - t0)
    lat = lat[10:]  # after the first calls' caches fill
    stats["encoder"] = {
        "passages": passages, "passages_per_s": passages / wall, "encode_s": wall,
        "stand_in_tokenize_s": tokenize_s,
        "tokens": sum(lengths), "token_length_histogram": buckets,
        "token_length_p50": percentile(lengths, 0.5), "flops": flops,
        "bound_ms": flops / PEAK_F32_FLOPS * 1e3, "bound_by": "operations",
        "query_encode_p50_ms": 1e3 * percentile(lat, 0.5),
        "query_encode_p95_ms": 1e3 * percentile(lat, 0.95)}
    log(f"retrieval encoder: {json.dumps(stats['encoder'])}")

    # -- index -----------------------------------------------------------
    inner = MemoryVectorStore()
    index = DeviceIndexedStore(inner, k_bucket=16, max_wave=16, device=dev)
    index.reserve(RETRIEVAL_TABLE, rows, dim=cfg.hidden_size)
    dup = rng.standard_normal(cfg.hidden_size).astype(np.float32)
    dup_rows = sorted({passages + 1000 + i for i in range(12)}
                      | {int(r) for r in rng.choice(np.arange(passages, rows), 8, replace=False)})
    t0 = time.monotonic()
    index.upsert(RETRIEVAL_TABLE, [Doc(f"c{i:06d}", texts[i], chunk_metadata(i), vecs[i])
                                   for i in range(passages)])
    step = 16384
    for start in range(passages, rows, step):
        stop = min(rows, start + step)
        block = rng.standard_normal((stop - start, cfg.hidden_size)).astype(np.float32)
        block /= np.linalg.norm(block, axis=1, keepdims=True)
        for r in dup_rows:
            if start <= r < stop:
                block[r - start] = dup
        index.upsert(RETRIEVAL_TABLE, [Doc(f"c{r:06d}", f"chunk {r}", chunk_metadata(r),
                                           block[r - start]) for r in range(start, stop)])
    stats["index_upsert_s"] = time.monotonic() - t0
    t0 = time.monotonic()
    index.search(RETRIEVAL_TABLE, dup, 1)  # the first search puts the whole table
    sync()
    stats["index_full_put_s"] = time.monotonic() - t0
    t0 = time.monotonic()
    index.warmup()
    sync()
    stats["index_warmup_s"] = time.monotonic() - t0
    warm_shapes = (index.search_program_cache_size(), index.mutation_program_cache_size())
    health0 = index.health()["device_index"][RETRIEVAL_TABLE]
    capacity = health0["capacity"]
    if capacity != next_bucket(rows, 1 << 30, minimum=64) or health0["live_rows"] != rows:
        raise RuntimeError(f"index table {health0}")
    corpus = index._tables[RETRIEVAL_TABLE].corpus_dev
    stats["corpus_mb"] = corpus.numel() * corpus.element_size() / 1e6

    # parity: a 16-query wave of encoded queries (8) and random vectors (8),
    # without and with filters, against the host store; the duplicated block
    wave_q = np.concatenate([enc.encode(queries_text[:8], kind="query"),
                             rng.standard_normal((8, cfg.hidden_size)).astype(np.float32)])
    filters = [None] * 16
    filtered = [None if i % 3 == 0 else {"repo": f"repo{i % 4}"} if i % 3 == 1
                else {"module": f"repo{i % 4}/mod{i % 8}", "namespace": "default"}
                for i in range(16)]
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True  # the index must hold IEEE float32 itself
    try:
        waves = [index.search_batch(RETRIEVAL_TABLE, wave_q, 16, flt) for flt in (filters, filtered)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    for flt, wave in zip((filters, filtered), waves):
        for host_hits, dev_hits, f in zip(
                [inner.search(RETRIEVAL_TABLE, q, 16, filter=f) for q, f in zip(wave_q, flt)],
                wave, flt):
            if len(dev_hits) != 16:
                raise RuntimeError(f"filter {f}: {len(dev_hits)} hits")
            same_ranking(host_hits, dev_hits)
    ties = index.search(RETRIEVAL_TABLE, dup, 16)
    want = [f"c{r:06d}" for r in dup_rows[:16]]
    if [h.doc.doc_id for h in ties] != want or len({h.score for h in ties}) != 1:
        raise RuntimeError(f"duplicated vectors: {[(h.doc.doc_id, h.score) for h in ties]}, "
                           f"expected {want} with one score (bit-equal columns)")
    before = counter_value(DEVICE_INDEX_SEARCHES, path="fallback")
    same_ranking(inner.search(RETRIEVAL_TABLE, wave_q[0], 17),
                 index.search(RETRIEVAL_TABLE, wave_q[0], 17))
    if counter_value(DEVICE_INDEX_SEARCHES, path="fallback") != before + 1:
        raise RuntimeError("k > DEVICE_INDEX_K_BUCKET was not counted as a fallback")

    # wave latency: wall per call and device time per call, waves of 1 and 16
    waves = {}
    for nq in (1, 16):
        qs = wave_q[:nq]

        def call(qs=qs):
            index.search_batch(RETRIEVAL_TABLE, qs, 16)

        call()
        walls = []
        for _ in range(30):
            t0 = time.monotonic()
            call()
            walls.append(time.monotonic() - t0)
        nbytes = (corpus.numel() * 4 + nq * cfg.hidden_size * 4 + nq * capacity  # corpus, q, mask
                  + nq * 16 * 12)  # top-k values and int64 rows out
        b_ms, b_by = bound(2.0 * nq * cfg.hidden_size * capacity, nbytes, PEAK_F32_FLOPS)
        kern = call_device_us(call, iters=10) if cuda else {}
        waves[nq] = {"wall_p50_ms": 1e3 * percentile(walls, 0.5),
                     "device_ms": sum(kern.values()) / 1e3, "kernels_us": kern,
                     "bound_ms": b_ms, "bound_by": b_by}
    mask = np.ones((16, capacity), dtype=bool)
    walls = []
    for _ in range(20):
        t0 = time.monotonic()
        torch.from_numpy(mask).to(dev)
        sync()
        walls.append(time.monotonic() - t0)
    waves[16]["mask_h2d_ms"] = 1e3 * percentile(walls, 0.5)
    stats["search"] = waves
    log(f"retrieval search: {json.dumps(waves)}")

    # -- coalesced retrieval ---------------------------------------------
    groups = [queries_text[t * per_thread:(t + 1) * per_thread] for t in range(threads)]
    direct = RetrieverFactory(index, enc, coalescer=False).for_scope("chunk")
    want_many = [direct.retrieve_many(g) for g in groups]
    if config.get_settings().retrieval_coalesce is not True:
        raise RuntimeError("RETRIEVAL_COALESCE is off in this environment")
    factory = RetrieverFactory(index, enc)
    coalesced = factory.for_scope("chunk")
    barrier = threading.Barrier(threads)

    def many(t):
        barrier.wait(60)
        return coalesced.retrieve_many(groups[t])

    with ThreadPoolExecutor(threads) as pool:
        got_many = list(pool.map(many, range(threads)))
    for want_g, got_g in zip(want_many, got_many):
        for a, b in zip(want_g, got_g):
            if ([d.doc_id for d in a] != [d.doc_id for d in b]
                    or max((abs(x.score - y.score) for x, y in zip(a, b)), default=0) > RETRIEVAL_TOL):
                raise RuntimeError("coalesced retrieve_many differs from the direct path")
    w0 = histogram_stats(RETRIEVAL_WAVE_SIZE)

    def single(t):
        barrier.wait(60)
        out = []
        for q in groups[t]:
            t0 = time.monotonic()
            coalesced.retrieve(q)
            out.append(time.monotonic() - t0)
        return out

    t0 = time.monotonic()
    with ThreadPoolExecutor(threads) as pool:
        lat = [x for xs in pool.map(single, range(threads)) for x in xs]
    wall = time.monotonic() - t0
    w1 = histogram_stats(RETRIEVAL_WAVE_SIZE)
    factory.coalescer.close()
    stats["coalesced"] = {
        "threads": threads, "calls": len(lat), "retrieve_p50_ms": 1e3 * percentile(lat, 0.5),
        "retrieve_p95_ms": 1e3 * percentile(lat, 0.95), "wall_s": wall,
        "mean_wave": (w1["sum"] - w0["sum"]) / max(1, w1["count"] - w0["count"]),
        "waves": w1["count"] - w0["count"]}
    log(f"retrieval coalesced: {json.dumps(stats['coalesced'])}")

    # -- live index: churn with queries running, then a snapshot ----------
    t = index._tables[RETRIEVAL_TABLE]
    live_q = rng.standard_normal((3, cfg.hidden_size)).astype(np.float32)
    live_q /= np.linalg.norm(live_q, axis=1, keepdims=True)
    host0 = t.host[:rows].copy()  # normalized rows, row = insertion order here
    near = {int(r) for q in live_q for r in np.argsort(-(host0 @ q))[:24]}
    pool_ids = sorted(near | {int(r) for r in rng.choice(np.arange(passages, rows), 300,
                                                          replace=False)})
    state = {f"c{r:06d}": host0[r].copy() for r in pool_ids}
    rest = np.ones(rows, dtype=bool)
    rest[pool_ids] = False
    base = []  # per query: the best 5 (score, id) of the rows the churn never touches
    for q in live_q:
        s = host0 @ q
        top = np.argsort(-np.where(rest, s, -np.inf))[:5]
        base.append([(float(s[r]), f"c{r:06d}") for r in top])

    def top5(qi):
        q = live_q[qi]
        cand = list(base[qi]) + [(float(v @ q), i) for i, v in state.items() if v is not None]
        cand.sort(key=lambda p: -p[0])
        return tuple(i for _, i in cand[:5])

    allowed = [{top5(i)} for i in range(3)]
    plan, dead = [], []
    for _ in range(churn_ops):
        roll = rng.random()
        live_ids = [i for i, v in state.items() if v is not None]
        if roll < 0.35:
            did = live_ids[int(rng.integers(len(live_ids)))]
            state[did] = None
            dead.append(did)
            plan.append(("delete", did, None))
        else:
            if dead and roll < 0.6:
                did = dead.pop(int(rng.integers(len(dead))))
            else:
                did = live_ids[int(rng.integers(len(live_ids)))]
            # near one of the queries, at a spread of distances: scores 0.1-0.9
            noise = rng.standard_normal(cfg.hidden_size) / np.sqrt(cfg.hidden_size)
            v = rng.uniform(0.1, 1.0) * live_q[int(rng.integers(3))] + noise
            v = (v / np.linalg.norm(v)).astype(np.float32)
            state[did] = v
            plan.append(("upsert", did, v))
        for i in range(3):
            allowed[i].add(top5(i))
    log_ = MutationLog()
    applier = LiveIndexApplier(log_, index, apply_batch=64, compact_interval_s=0.05)
    compact_ms = []
    compact_table = index._compact_table

    def timed_compact(tab):
        t0 = time.monotonic()
        out = compact_table(tab)
        sync()
        compact_ms.append(1e3 * (time.monotonic() - t0))
        return out

    index._compact_table = timed_compact
    observed = [set() for _ in range(3)]
    stop, errors = threading.Event(), []

    def query_loop():
        n = 0
        try:
            while not stop.is_set():
                hits = index.search(RETRIEVAL_TABLE, live_q[n % 3], 5)
                observed[n % 3].add(tuple(h.doc.doc_id for h in hits))
                n += 1
        except BaseException as exc:  # noqa: BLE001 - raised below, after the join
            errors.append(exc)

    syncs0 = health0["full_syncs"]
    applier.start()
    qthreads = [threading.Thread(target=query_loop) for _ in range(2)]
    t0 = time.monotonic()
    try:
        for th in qthreads:
            th.start()
        for kind, did, v in plan:
            if kind == "delete":
                log_.append_delete(RETRIEVAL_TABLE, [did])
            else:
                row = int(did[1:])
                log_.append_upsert(RETRIEVAL_TABLE, [Doc(did, f"chunk {row}", chunk_metadata(row), v)])
        if not applier.flush(timeout=300):
            raise RuntimeError("the applier did not catch up with the log")
        apply_s = time.monotonic() - t0
    finally:
        stop.set()
        for th in qthreads:
            th.join(60)
        applier.stop()
        index._compact_table = compact_table
    if errors or any(th.is_alive() for th in qthreads):
        raise RuntimeError(f"query threads: {errors}")
    for i in range(3):
        rogue = observed[i] - allowed[i]
        if not observed[i] or rogue:
            raise RuntimeError(f"query {i} saw states that are no prefix of the stream: {rogue}")
    health1 = index.health()["device_index"][RETRIEVAL_TABLE]
    if (health1["full_syncs"] != syncs0 or health1["capacity"] != capacity
            or health1["compactions"] == health0["compactions"]
            or health1["holes"] >= applier.compact_min_holes):
        raise RuntimeError(f"churn: {health0} -> {health1}")
    if (index.search_program_cache_size(), index.mutation_program_cache_size()) != warm_shapes:
        raise RuntimeError("live traffic dispatched shapes warmup did not")
    for flt in (filters, filtered):
        for host_hits, dev_hits in zip(
                [inner.search(RETRIEVAL_TABLE, q, 16, filter=f) for q, f in zip(wave_q, flt)],
                index.search_batch(RETRIEVAL_TABLE, wave_q, 16, flt)):
            same_ranking(host_hits, dev_hits)
    stats["live"] = {"ops": len(plan), "apply_s": apply_s, "ops_per_s": len(plan) / apply_s,
                     "compactions": health1["compactions"] - health0["compactions"],
                     "compaction_ms": [round(x, 1) for x in compact_ms],
                     "holes_after": health1["holes"], "observed_states": sum(map(len, observed))}

    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    snap = tempfile.mkdtemp(prefix="snapshot-", dir=kernels.BUILD_DIR)
    try:
        t0 = time.monotonic()
        manifest = save_snapshot(index, snap, watermark=applier.applied_seq())
        save_s = time.monotonic() - t0
        late = rng.standard_normal(cfg.hidden_size).astype(np.float32)
        log_.append_upsert(RETRIEVAL_TABLE, [Doc("c000123", "late", chunk_metadata(123), late)])
        log_.append_delete(RETRIEVAL_TABLE, ["c000124"])
        applier.drain()
        replica = DeviceIndexedStore(MemoryVectorStore(), k_bucket=16, max_wave=16, device=dev)
        t0 = time.monotonic()
        out = restore_replica(snap, replica, log=log_)
        replica.search(RETRIEVAL_TABLE, dup, 1)  # the whole-table put
        sync()
        restore_s = time.monotonic() - t0
    finally:
        shutil.rmtree(snap, ignore_errors=True)
    if out["replayed"] != 2 or replica.count(RETRIEVAL_TABLE) != index.count(RETRIEVAL_TABLE):
        raise RuntimeError(f"restore replayed {out['replayed']}, "
                           f"{replica.count(RETRIEVAL_TABLE)} rows vs {index.count(RETRIEVAL_TABLE)}")
    for flt in (filters, filtered):
        for a, b in zip(index.search_batch(RETRIEVAL_TABLE, wave_q, 16, flt),
                        replica.search_batch(RETRIEVAL_TABLE, wave_q, 16, flt)):
            if [(h.doc.doc_id, h.score) for h in a] != [(h.doc.doc_id, h.score) for h in b]:
                raise RuntimeError("the restored replica's ranking is not identical")
    a, b = index.search(RETRIEVAL_TABLE, dup, 16), replica.search(RETRIEVAL_TABLE, dup, 16)
    if [(h.doc.doc_id, h.score) for h in a] != [(h.doc.doc_id, h.score) for h in b]:
        raise RuntimeError("the restored replica breaks ties differently")
    stats["snapshot"] = {"rows": manifest["tables"][0]["count"], "save_s": save_s,
                         "restore_s": restore_s, "replayed": out["replayed"]}
    log(f"retrieval live index: {json.dumps(stats['live'])}; snapshot {json.dumps(stats['snapshot'])}")

    launches = read_launches()
    if any(launches.values()):
        raise RuntimeError(f"the retrieval path launched kernels: "
                           f"{ {k: n for k, n in launches.items() if n} }")
    stats["kernel_launches"] = sum(launches.values())
    stats["shapes"] = {"search": warm_shapes[0], "mutation": warm_shapes[1]}
    if cuda:
        stats["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    stats["phase_s"] = time.monotonic() - t_phase
    if keep is not None:
        keep.update(index=index, encoder=enc)
    return stats


def package_presence() -> dict:
    """Whether the packages the JAX package's later layers use import here."""
    import importlib

    out = {}
    for name in ("transformers", "prometheus_client", "pydantic", "psutil", "requests"):
        try:
            importlib.import_module(name)
            out[name] = True
        except Exception:  # noqa: BLE001 - any failure to import is "no"
            out[name] = False
    return out


# /health's key set in the JAX package (its AsyncEngine.stats() plus status)
HEALTH_KEYS = {
    "status", "role", "running", "waiting", "requests_admitted", "free_pages", "total_pages",
    "prefix_cache_hit_tokens", "sp_prefills", "sp_ring_segments", "sp_ring_tokens",
    "spec_proposed", "spec_accepted", "spec_acceptance_rate", "spec_fallbacks", "deadline_reaps",
    "kv_host_pages", "kv_fault_ins", "kv_writebacks", "kv_dedup_hits", "kv_dedup_holds",
    "kv_pages_exported", "kv_pages_imported", "parked", "preemptions", "preempted_pages",
    "preempt_resumes", "resume_faulted_pages", "resume_recomputed_tokens",
    "resume_recomputed_prompt_tokens",
}


# the engine phase's geometry, as the entry points read it
ENGINE_GEOMETRY = {"MAX_NUM_SEQS": "8", "KV_NUM_PAGES": "256", "KV_PAGE_SIZE": "128",
                   "PREFILL_CHUNK": "512", "CONTEXT_WINDOW": "11712"}


def _http(port: int, method: str, path: str, body: bytes | None = None):
    """(status, parsed JSON body, SSE events or text, (start, end)
    monotonic times) of one request on a fresh connection; SSE bodies
    become a list of parsed events ending in "[DONE]"."""
    import http.client

    t0 = time.monotonic()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request(method, path, body=body, headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        if resp.getheader("Content-Type") == "text/event-stream":
            events = []
            for block in data.decode().split("\n\n"):
                if not block:
                    continue
                if not block.startswith("data: "):
                    raise RuntimeError(f"not an SSE data event: {block[:80]!r}")
                payload = block[len("data: "):]
                events.append(payload if payload == "[DONE]" else json.loads(payload))
            return resp.status, events, (t0, time.monotonic())
        if resp.getheader("Content-Type", "").startswith("text/plain"):
            return resp.status, data.decode(), (t0, time.monotonic())
        return resp.status, json.loads(data), (t0, time.monotonic())
    finally:
        conn.close()


def phase_http(cfg, params) -> dict:
    """Serve the in-memory 7B bf16 tree over HTTP on localhost through the
    port's entry points: settings from the environment (the engine phase's
    geometry), build_engine, AsyncEngine, OpenAIServer with the byte
    tokenizer.  Stdlib clients in threads send /health, /v1/models, a
    greedy chat, a streamed chat, a completion, a malformed body and a wave
    of 8 concurrent streamed chats; every launch count is set to 0 just
    before the requests and read just after."""
    import os
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from githubrepostorag_tpu_torch import config
    from githubrepostorag_tpu_torch.serving import AsyncEngine
    from githubrepostorag_tpu_torch.serving.__main__ import build_engine
    from githubrepostorag_tpu_torch.serving.openai_api import OpenAIServer
    from githubrepostorag_tpu_torch.serving.tokenizer import ByteTokenizer

    os.environ.update(ENGINE_GEOMETRY)
    s = config.reload_settings()
    engine = build_engine(s, params, cfg, "cuda")
    t0 = time.monotonic()
    engine.warmup()
    torch.cuda.synchronize()
    log(f"http engine warmup {time.monotonic() - t0:.1f} s")
    aeng = AsyncEngine(engine)
    results = {}  # request id -> the engine's GenerationResult
    engine_stream = aeng.stream

    async def recording_stream(*args, **kw):
        async for event in engine_stream(*args, **kw):
            if event.type == "final":
                results[event.result.request_id] = event.result
            yield event

    aeng.stream = recording_stream
    tok = ByteTokenizer()
    server = OpenAIServer(aeng, tok, model_name=s.qwen_model)
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, name="http-server", daemon=True)
    thread.start()

    def run(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(600)

    rng = np.random.default_rng(SEED + 11)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz  ,.", dtype=np.uint8)

    def text(n):
        return bytes(rng.choice(letters, n)).decode()

    def chat(content, max_tokens, stream):
        return json.dumps({"messages": [{"role": "user", "content": content}],
                           "max_tokens": max_tokens, "temperature": 0, "stream": stream}).encode()

    def engine_result(rid, want_tokens):
        res = results.get(rid)
        if res is None or res.finish_reason not in ("length", "stop"):
            raise RuntimeError(f"{rid}: engine result {res}")
        if res.finish_reason == "length" and len(res.output_tokens) != want_tokens:
            raise RuntimeError(f"{rid}: {len(res.output_tokens)} tokens, expected {want_tokens}")
        return res

    def finished_stream(status, events, want_tokens):
        if status != 200 or events[-1] != "[DONE]":
            raise RuntimeError(f"stream: status {status}, last event {events[-1]!r}")
        if events[-2]["choices"][0]["finish_reason"] is None:
            raise RuntimeError("stream: the final chunk carries no finish_reason")
        rid = events[0]["id"]
        if any(e["id"] != rid for e in events[:-1]):
            raise RuntimeError(f"stream {rid}: chunks of other requests on its connection")
        res = engine_result(rid, want_tokens)
        streamed = "".join(e["choices"][0]["delta"].get("content", "") for e in events[:-1])
        if streamed != tok.decode(res.output_tokens):
            raise RuntimeError(f"stream {rid}: the deltas are not the decoded engine tokens")
        return res

    port = run(server.start("127.0.0.1", 0))
    stats = {}
    try:
        reset_launches()
        status, health, _ = _http(port, "GET", "/health")
        if status != 200 or set(health) != HEALTH_KEYS:
            raise RuntimeError(f"/health: {status}, keys {sorted(set(health) ^ HEALTH_KEYS)} differ")
        status, models, _ = _http(port, "GET", "/v1/models")
        if status != 200 or models["data"][0]["id"] != s.qwen_model:
            raise RuntimeError(f"/v1/models: {status} {models}")
        stats["debug_index"] = debug_index_check(port)
        for path, body in (("/v1/chat/completions", chat(text(200), 32, False)),
                           ("/v1/completions", json.dumps({"prompt": text(300), "max_tokens": 32,
                                                           "temperature": 0}).encode())):
            status, reply, _ = _http(port, "POST", path, body)
            res = engine_result(reply["id"], 32) if status == 200 else None
            if res is None or reply["usage"]["completion_tokens"] != len(res.output_tokens):
                raise RuntimeError(f"{path}: {status} {reply}")
            choice = reply["choices"][0]
            got = choice["message"]["content"] if "message" in choice else choice["text"]
            if got != tok.decode(res.output_tokens):
                raise RuntimeError(f"{path}: the reply is not the decoded engine tokens")
        finished_stream(*_http(port, "POST", "/v1/chat/completions", chat(text(150), 32, True))[:2],
                        32)
        status, reply, _ = _http(port, "POST", "/v1/chat/completions", b'{"messages": ')
        if status != 400 or "error" not in reply:
            raise RuntimeError(f"malformed body: {status} {reply}")

        sizes = [100, 700, 1500, 3000, 1224, 256, 256, 256]
        bodies = [chat(text(n), 64, True) for n in sizes]
        t0 = time.monotonic()
        with ThreadPoolExecutor(len(bodies)) as pool:
            wave = list(pool.map(lambda b: _http(port, "POST", "/v1/chat/completions", b), bodies))
        wall = time.monotonic() - t0
        torch.cuda.synchronize()
        launches = read_launches()
        wave_res = [finished_stream(st, ev, 64) for st, ev, _ in wave]
        latency = sorted(end - start for _, _, (start, end) in wave)
        # outside the engine's submit-to-done time: before, the request's
        # parse on the loop and the wait for the step the driver is in (it
        # takes submissions between steps); after, the last events' and the
        # closing chunks' delivery, the front end's alone
        before = sorted(r.timings["submit_t"] - start for (_, _, (start, _)), r in zip(wave, wave_res))
        after = sorted(end - r.timings["done_t"] for (_, _, (_, end)), r in zip(wave, wave_res))
        ttft = sorted(r.ttft_s for r in wave_res)
        tokens = sum(len(r.output_tokens) for r in wave_res)
        a, b = "fused_window_attention", "paged_attention_decode_staged"
        if launches[a] <= 0 or launches[b] <= 0:
            raise RuntimeError(f"the HTTP path launched A {launches[a]}, B {launches[b]} times")
        off = {k: n for k, n in launches.items() if k.split("@")[0] not in (a, b) and n}
        if off:
            raise RuntimeError(f"the HTTP path launched kernels it never reaches: {off}")
        stats.update({
            "wave_prompt_bytes": sizes,
            "wave_completion_tokens": tokens,
            "latency_p50_s": latency[len(latency) // 2],
            "latency_p95_s": latency[min(len(latency) - 1, int(0.95 * len(latency)))],
            "completion_tok_s": tokens / wall,
            "engine_ttft_p50_s": ttft[len(ttft) // 2],
            "send_to_submit_ms": [round(1e3 * x, 1) for x in before],
            "done_to_client_ms_p50": 1e3 * after[len(after) // 2],
            "done_to_client_ms_max": 1e3 * after[-1],
            "engine_ttft_s": [round(x, 4) for x in ttft],
            "wave_wall_s": wall,
            "requests": len(results),
            "launches": launches,
        })
    finally:
        run(server.stop())
        loop.call_soon_threadsafe(loop.stop)
        thread.join(30)
        loop.close()
    if engine.has_work() or engine._allocator.free_count != engine._allocator.num_pages:
        raise RuntimeError("pages leaked after the HTTP server stopped")
    log(f"http server on {torch.cuda.get_device_name(0)}: {json.dumps(stats)}")
    return stats


DEBUG_INDEX_KEYS = {"enabled", "watermark", "lag_ops", "ops_applied", "tables", "compaction"}


def debug_index_check(port: int, device: str = "cuda") -> dict:
    """GET /debug/index without a live-index applier registered ({"enabled":
    false}) and with one that drained 40 upserts and 3 deletes into a device
    index on the card (its watermarks, tables and compaction settings)."""
    from githubrepostorag_tpu_torch.ingest.stream import MutationLog
    from githubrepostorag_tpu_torch.retrieval import (
        DeviceIndexedStore, LiveIndexApplier, register_live_applier)
    from githubrepostorag_tpu_torch.store.base import Doc
    from githubrepostorag_tpu_torch.store.memory import MemoryVectorStore

    status, off, _ = _http(port, "GET", "/debug/index")
    if status != 200 or off != {"enabled": False}:
        raise RuntimeError(f"/debug/index with no applier: {status} {off}")
    rng = np.random.default_rng(SEED + 13)
    log_ = MutationLog()
    log_.append_upsert("t", [Doc(f"d{i}", f"doc {i}", {"repo": f"r{i % 4}"},
                                 rng.standard_normal(384).astype(np.float32)) for i in range(40)])
    log_.append_delete("t", ["d1", "d2", "d3"])
    applier = LiveIndexApplier(log_, DeviceIndexedStore(MemoryVectorStore(), device=device))
    applier.drain()
    register_live_applier(applier)
    try:
        status, on, _ = _http(port, "GET", "/debug/index")
    finally:
        register_live_applier(None)
    if (status != 200 or set(on) != DEBUG_INDEX_KEYS or on["enabled"] is not True
            or on["watermark"]["applied"] != 43 or on["lag_ops"] != 0
            or on["tables"]["t"]["live_rows"] != 37 or on["tables"]["t"]["holes"] != 3):
        raise RuntimeError(f"/debug/index with an applier: {status} {on}")
    return {"off": off, "on": {"applied": on["watermark"]["applied"],
                               "tables": on["tables"]}}


# -- the question-answering loop ------------------------------------------

RAG_MAX_OUTPUT = 64  # QWEN_MAX_OUTPUT: a random 7B model rarely emits EOS
RAG_DEADLINE_MS = 600  # the reaped job's budget: its first engine call outlives it
RAG_LEDGER_WINDOW_S = 900  # the token ledger's window in the rag phase: all of its jobs
REPO_CHUNKS = 2048  # chunks a repository (chunk_metadata)


def e5_encoder(dev, cfg=None):
    """The retrieval phase's encoder: e5-small widths (``cfg`` for a smaller
    rehearsal), random float32 weights from the seed, the stdlib stand-in
    tokenizer; warmed up.  Returns (encoder, cfg)."""
    from githubrepostorag_tpu_torch.embedding import TorchBertTextEncoder
    from githubrepostorag_tpu_torch.models.encoder import BertConfig, init_params

    import torch

    cfg = cfg or BertConfig.e5_small()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 21)
    enc = TorchBertTextEncoder(init_params(cfg, gen, device=dev), cfg,
                               SmokeTokenizer(cfg.vocab_size), device=dev,
                               max_length=cfg.max_position_embeddings)
    enc.warmup()
    return enc, cfg


def rag_index(dev, cfg=None, rows: int = 258048, passages: int = 1024):
    """The retrieval phase's deployment at the same size, for ``--only
    rag``: e5-small-width encoder (random float32 weights from the seed),
    ``passages`` encoded code chunks and random unit vectors for the rest
    of ``rows`` chunks in the device index."""
    from githubrepostorag_tpu_torch.retrieval import DeviceIndexedStore
    from githubrepostorag_tpu_torch.store.base import Doc
    from githubrepostorag_tpu_torch.store.memory import MemoryVectorStore

    rng = np.random.default_rng(SEED + 21)
    enc, cfg = e5_encoder(dev, cfg)
    texts = code_passages(rng, passages)
    vecs = enc.encode(texts, kind="passage")
    index = DeviceIndexedStore(MemoryVectorStore(), k_bucket=16, max_wave=16, device=dev)
    index.reserve(RETRIEVAL_TABLE, rows, dim=cfg.hidden_size)
    index.upsert(RETRIEVAL_TABLE, [Doc(f"c{i:06d}", texts[i], chunk_metadata(i), vecs[i])
                                   for i in range(passages)])
    for start in range(passages, rows, 16384):
        stop = min(rows, start + 16384)
        block = rng.standard_normal((stop - start, cfg.hidden_size)).astype(np.float32)
        block /= np.linalg.norm(block, axis=1, keepdims=True)
        index.upsert(RETRIEVAL_TABLE, [Doc(f"c{r:06d}", f"chunk {r}", chunk_metadata(r),
                                           block[r - start]) for r in range(start, stop)])
    index.search(RETRIEVAL_TABLE, vecs[0], 1)  # the first search puts the whole table
    index.warmup()
    return index, enc, passages


def rag_hierarchy(index, enc, rows: int, seed: int = SEED + 31) -> dict:
    """``rag_hierarchy_docs`` written into ``index`` and warmed up.
    Returns the rows a table."""
    from githubrepostorag_tpu_torch import config

    tables = config.get_settings().scope_tables
    docs = rag_hierarchy_docs(enc, rows, seed)
    for scope, rows_ in docs.items():
        index.upsert(tables[scope], rows_)
    index.warmup([tables[s] for s in docs])
    return {scope: len(rows_) for scope, rows_ in docs.items()}


def rag_hierarchy_docs(enc, rows: int, seed: int = SEED + 31) -> dict:
    """Repo-, module- and file-level docs (and the namespace's catalog doc)
    for the chunk table's repositories, so that every rung of the agent's
    scope ladder has rows: summaries of repositories and modules encoded,
    file docs with random unit vectors.  Returns the docs by scope."""
    from githubrepostorag_tpu_torch.store.base import Doc

    rng = np.random.default_rng(seed)
    repos = -(-rows // REPO_CHUNKS)
    md = [chunk_metadata(r * REPO_CHUNKS) for r in range(repos)]
    repo_texts = [f"{m['repo']}: a code repository of 8 modules ({', '.join(_IDENTS[:4])}) "
                  f"and 256 files" for m in md]
    mods = [(m["repo"], f"{m['repo']}/mod{j}") for m in md for j in range(8)]
    mod_texts = [f"module {mod} of {repo}: {' '.join(rng.choice(_IDENTS, 6))}"
                 for repo, mod in mods]
    vecs = enc.encode([f"catalog of {repos} repositories"] + repo_texts + mod_texts,
                      kind="passage")
    dim = vecs.shape[1]
    ns = {"namespace": "default"}
    docs = {
        "catalog": [Doc("catalog:default", f"catalog of {repos} repositories",
                        {**ns, "scope": "catalog"}, vecs[0])],
        "repo": [Doc(f"repo:{m['repo']}", t, {**ns, "scope": "repo", "repo": m["repo"]}, v)
                 for m, t, v in zip(md, repo_texts, vecs[1:1 + repos])],
        "module": [Doc(f"module:{mod}", t, {**ns, "scope": "module", "repo": repo,
                                            "module": mod}, v)
                   for (repo, mod), t, v in zip(mods, mod_texts, vecs[1 + repos:])],
    }
    files = [(repo, mod, f"{mod}/file{k}.py") for repo, mod in mods for k in range(32)]
    fvec = rng.standard_normal((len(files), dim)).astype(np.float32)
    fvec /= np.linalg.norm(fvec, axis=1, keepdims=True)
    docs["file"] = [Doc(f"file:{path}", f"file {path}: {' '.join(rng.choice(_IDENTS, 5))}",
                        {**ns, "scope": "file", "repo": repo, "module": mod,
                         "file_path": path}, v)
                    for (repo, mod, path), v in zip(files, fvec)]
    return docs


def rag_job(port: int, body: dict, cancel_on_turn: bool = False, started=None) -> dict:
    """POST one job, read its SSE stream to its terminal event (cancelling
    the job at its first ``turn`` event when asked), then GET its result.
    The API ends a stream at ``final`` or, for a failed job, at the
    ``error`` event the worker emits just before its empty ``final`` (as
    the JAX API does).  ``started`` (a ``threading.Event``) is set at the
    stream's first event, or when the call ends without one.  Returns the
    reply, the events and the POST -> terminal event wall time."""
    try:
        return _rag_job(port, body, cancel_on_turn, started)
    finally:
        if started is not None:
            started.set()


def _rag_job(port: int, body: dict, cancel_on_turn: bool, started) -> dict:
    import http.client

    t0 = time.monotonic()
    status, reply, _ = _http(port, "POST", "/rag/jobs", json.dumps(body).encode())
    if status != 200:
        raise RuntimeError(f"POST /rag/jobs {body}: {status} {reply}")
    job_id = reply["job_id"]
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    events, cancelled_at = [], None
    try:
        conn.request("GET", f"/rag/jobs/{job_id}/events")
        resp = conn.getresponse()
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            events.append(json.loads(line[len("data: "):]))
            if started is not None:
                started.set()
            if cancel_on_turn and cancelled_at is None and events[-1]["event"] == "turn":
                status, ack, _ = _http(port, "POST", f"/rag/jobs/{job_id}/cancel")
                if status != 200 or ack != {"job_id": job_id, "cancelled": True}:
                    raise RuntimeError(f"cancel {job_id}: {status} {ack}")
                cancelled_at = len(events)
            if events[-1]["event"] in ("final", "error"):
                break
    finally:
        conn.close()
    wall = time.monotonic() - t0
    if not events or events[-1]["event"] not in ("final", "error"):
        raise RuntimeError(f"job {job_id} ({body['query']!r}) ended without a terminal event: "
                           f"{events[-3:]}")
    # the worker emits the terminal event, then keeps the result: over
    # Redis the stream can outrun the SET
    deadline = time.monotonic() + 10
    while True:
        status, result, _ = _http(port, "GET", f"/rag/jobs/{job_id}/result")
        if status != 404 or time.monotonic() > deadline:
            break
        time.sleep(0.02)
    if status != 200:
        raise RuntimeError(f"GET result of {job_id}: {status} {result}")
    return {"body": body, "reply": reply, "events": events, "wall_s": wall, "result": result,
            "cancelled_at": cancelled_at}


def run_rag_jobs(port: int, jobs: list) -> list:
    """Run ``rag_jobs``' eight jobs at once, each in a thread of its own,
    and return their ``rag_job`` records in the list's order.  The
    deadline job goes first and the other seven follow once its stream
    shows the worker has started it: its RAG_DEADLINE_MS budget runs from
    the POST, and queued behind seven jobs that load the engine and the
    host, its transit alone outlasted the budget over Redis on the card,
    so the job expired before its first engine call and nothing was left
    for the engine to reap."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    lead = next(i for i, (body, _) in enumerate(jobs) if "deadline_ms" in body)
    started = threading.Event()
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {lead: pool.submit(rag_job, port, *jobs[lead], started=started)}
        started.wait(60)
        futures.update({i: pool.submit(rag_job, port, *job)
                        for i, job in enumerate(jobs) if i != lead})
        return [futures[i].result() for i in range(len(jobs))]


def _spans_by_id(trace: dict) -> dict:
    return {sp["span_id"]: sp for sp in trace["spans"]}


def synthesis_ttft(trace: dict) -> dict:
    """The synthesis call's engine time to first token (queue wait +
    prefill, the engine's submit -> first token) and its prefill alone,
    from the engine spans under the synthesis stage's ``llm.generate``."""
    spans = _spans_by_id(trace)

    def under(sp, stage):
        while sp is not None:
            if sp["name"] == stage:
                return True
            sp = spans.get(sp["parent_id"])
        return False

    gens = [sp for sp in trace["spans"] if sp["name"] == "llm.generate"
            and (under(sp, "agent.synthesize") or under(sp, "agent.longctx"))]
    if not gens:
        raise RuntimeError(f"trace {trace['trace_id']}: no synthesis llm.generate")
    gen = gens[0]
    kids = {sp["name"]: sp for sp in trace["spans"] if sp["parent_id"] == gen["span_id"]}
    if "engine.prefill" not in kids:
        raise RuntimeError(f"trace {trace['trace_id']}: the synthesis call has no engine.prefill")
    wait = kids["engine.queue_wait"]["duration_s"] if "engine.queue_wait" in kids else 0.0
    return {"ttft_s": wait + kids["engine.prefill"]["duration_s"],
            "prefill_s": kids["engine.prefill"]["duration_s"],
            "prompt_tokens": kids["engine.prefill"]["attrs"]["prompt_tokens"]}


def rag_settings(geometry: dict | None = None, prefill_priority: bool = False):
    """The rag phase's settings, put into the environment (the entry
    points read them there): the engine phase's geometry, QWEN_MAX_OUTPUT
    set to RAG_MAX_OUTPUT, the in-process LLM backend, a token-ledger
    window that holds the whole phase (SLO_LEDGER_WINDOW_S)."""
    import os

    from githubrepostorag_tpu_torch import config

    os.environ.update(geometry or ENGINE_GEOMETRY, QWEN_MAX_OUTPUT=str(RAG_MAX_OUTPUT),
                      LLM_BACKEND="inprocess", PREFILL_PRIORITY=str(int(prefill_priority)),
                      SLO_LEDGER_WINDOW_S=str(RAG_LEDGER_WINDOW_S))
    return config.reload_settings()


def rag_llm(cfg, params, device: str = "cuda"):
    """The rag phase's LLM: ``api/__main__.inprocess_llm`` over the model
    server's ``build_engine`` with the settings ``rag_settings`` put in
    place and the byte tokenizer, warmed up.  Returns (llm, seconds to
    build and warm up)."""
    import torch

    from githubrepostorag_tpu_torch.api.__main__ import inprocess_llm
    from githubrepostorag_tpu_torch.config import get_settings
    from githubrepostorag_tpu_torch.serving.tokenizer import ByteTokenizer

    t0 = time.monotonic()
    llm = inprocess_llm(get_settings(), params, cfg, ByteTokenizer(), device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return llm, time.monotonic() - t0


def rag_jobs(short: int, code_repos: tuple[str, str] = ("repo0", "repo1")) -> list:
    """The rag phase's eight jobs: (body, cancel at the first turn).  Code
    questions on ``code_repos``, repo questions on the repositories from
    ``short`` on, the whole-repo architecture question on ``short``, one
    job cancelled at its first turn, one whose deadline the engine reaps."""
    return [
        ({"query": f"what does the function parse_tree return in repo: {code_repos[0]}?"}, False),
        ({"query": f"why does index_query raise an exception in repo: {code_repos[1]}?"}, False),
        ({"query": "how is the token batch retry implemented?"}, False),
        ({"query": f"tell me about repo: repo{short + 1}"}, False),
        ({"query": "what projects exist in this workspace?"}, False),
        ({"query": f"explain the architecture of repo: repo{short} and how the pieces "
                   "fit together"}, False),
        ({"query": f"describe the modules of repo: repo{short + 2}"}, True),
        ({"query": f"summarize repo: repo{short + 3}", "deadline_ms": RAG_DEADLINE_MS}, False),
    ]


def first_llm_start(trace: dict | None) -> float | None:
    """Seconds from a job's root span to its first ``llm.generate`` span
    (None: the job's budget ran out before its first LLM call, which then
    never reached the engine)."""
    starts = [sp["start_s"] for sp in (trace or {}).get("spans", [])
              if sp["name"] == "llm.generate"]
    return min(starts) if starts else None


def terminal_state(job: dict) -> str:
    """How a job of ``rag_job`` ended: "cancelled", "deadline" (its
    ``error`` event names the deadline), "error" or "final"."""
    last = job["events"][-1]
    if last["event"] == "error":
        return "deadline" if "deadline" in last["data"].get("error", "") else "error"
    return "cancelled" if last["data"].get("cancelled") is True else "final"


def _shape(value):
    """The committed schema scripts' type shape (scripts/check_*_schema.py)."""
    if isinstance(value, dict):
        return {k: _shape(v) for k, v in sorted(value.items())}
    if isinstance(value, list):
        return [_shape(value[0])] if value else []
    if isinstance(value, bool):
        return "bool"
    if isinstance(value, (int, float)):
        return "number"
    if value is None:
        return "null"
    return type(value).__name__


def conforms(got, golden, path: str = "$") -> None:
    """Raise unless a live body's shape fits the golden one: every key it
    has, the golden has with the same shape (a dict keyed by names --
    replicas, classes, request ids -- holds its values to the golden's one
    entry; an empty golden map takes any names); a section the golden
    fills may be null or empty (no router, no controller); a replica's
    ``stats`` is its engine's own dict."""
    if got in ("null", []) or (got == {} and isinstance(golden, dict)):
        return
    if path.endswith(".stats"):
        if not isinstance(got, dict):
            raise RuntimeError(f"{path}: {got}")
        return
    if isinstance(golden, dict):
        if not isinstance(got, dict):
            raise RuntimeError(f"{path}: {got} where the golden schema has {golden}")
        if not golden:  # a map by name the golden build left empty
            return
        for k, v in got.items():
            if k in golden:
                conforms(v, golden[k], f"{path}.{k}")
            elif len(golden) == 1:
                conforms(v, next(iter(golden.values())), f"{path}.{k}")
            else:
                raise RuntimeError(f"{path}: key {k!r} is not in the golden schema")
    elif isinstance(golden, list):
        if not isinstance(got, list):
            raise RuntimeError(f"{path}: {got} where the golden schema has a list")
        if got and golden:
            conforms(got[0], golden[0], f"{path}[0]")
    elif got != golden and golden != "null":
        raise RuntimeError(f"{path}: {got} where the golden schema has {golden}")


def rag_obs_check(port: int, aeng, before: dict) -> dict:
    """The observability planes over the rag phase's jobs, through the RAG
    API on localhost: /debug/slo, /debug/hbm, /debug/timeline and
    /debug/fleet, each body held to the committed golden schemas
    (tests/golden/); the compile watchdog 0 after warmup; the ledger's
    committed tokens equal the engine's and the finished requests' tokens;
    the page observatory's attributed page-seconds within 1 % of its
    occupancy integral (the JAX test's tolerance); the ledger's buckets,
    limiter, scheduler stall p50, goodput and MFU (against
    CHIP_PEAK_TFLOPS, the card's 989 TFLOP/s dense bf16); the obs hooks'
    host us a step beside the step's."""
    from pathlib import Path

    from githubrepostorag_tpu_torch.config import get_settings
    from githubrepostorag_tpu_torch.metrics import DECODE_TOKENS, XLA_COMPILES, counter_value

    golden_dir = Path(__file__).resolve().parent / "tests" / "golden"
    slo_g = json.loads((golden_dir / "debug_slo_schema.json").read_text())
    tl_g = json.loads((golden_dir / "debug_timeline_schema.json").read_text())
    time.sleep(0.2)  # the driver's hooks after its last step (it idles in 20 ms waits)
    bodies = {}
    for path in ("/debug/slo", "/debug/hbm", "/debug/timeline?window_s=600", "/debug/fleet"):
        status, body, _ = _http(port, "GET", path)
        if status != 200:
            raise RuntimeError(f"GET {path} -> {status}")
        bodies[path.split("?")[0]] = body
    conforms(_shape(bodies["/debug/slo"]), slo_g["GET /debug/slo"])
    conforms(_shape(bodies["/debug/fleet"]), slo_g["GET /debug/fleet"])
    conforms(_shape(bodies["/debug/hbm"]), tl_g["GET /debug/hbm"])
    tl = bodies["/debug/timeline"]
    conforms(_shape({**tl, "traceEvents": []}), tl_g["GET /debug/timeline"])
    kinds = {}
    for ev in tl["traceEvents"]:
        key = (f"M:{ev['name']}" if ev["ph"] == "M" else
               "C:" + ev["name"].split(" ", 1)[-1] if ev["ph"] == "C" else
               f"{ev['ph']}:{ev.get('cat', '')}")
        kinds.setdefault(key, _shape(ev))
    for key, shp in kinds.items():
        if key not in tl_g["GET /debug/timeline traceEvents"]:
            raise RuntimeError(f"timeline event kind {key} is not in the golden schema")
        want = tl_g["GET /debug/timeline traceEvents"][key]
        if key in ("X:span", "i:span_event"):
            # a span's args carry its own attributes (an HTTP status, a
            # query): only the trace ids are fixed keys
            shp, want = dict(shp), dict(want)
            got_args, want_args = shp.pop("args"), want.pop("args")
            ids = ("trace_id", "span_id") if key == "X:span" else ()
            conforms({k: got_args[k] for k in ids}, {k: want_args[k] for k in ids},
                     f"$.{key}.args")
        conforms(shp, want, f"$.{key}")
    src = tl["metadata"]["sources"]
    if not (src["spans"] > 0 and src["steps"] > 0 and src["samples"] > 0):
        raise RuntimeError(f"timeline sources {src}")
    replica = aeng.replica
    compiles = counter_value(XLA_COMPILES, replica=replica) - before["compiles"]
    if compiles != 0:
        raise RuntimeError(f"the compile watchdog counted {compiles} during the rag jobs")
    ledger = next(r["ledger"] for r in bodies["/debug/fleet"]["replicas"]
                  if r["replica"] == replica)
    # the ledger's first step differences the engine's counters against
    # zero, as the JAX ledger does, so its window also holds the tokens
    # warmup committed before the driver ran: it must equal the engine's
    # whole count, and the jobs' tokens the engine's count over the jobs
    committed = ledger["tokens"]["committed"]
    warmup_tokens = before["engine_committed"] if before["ledger_steps"] == 0 else None
    engine_tokens = aeng.engine.committed_tokens - before["engine_committed"]
    finished_tokens = counter_value(DECODE_TOKENS, replica=replica) - before["decode_tokens"]
    expect = aeng.engine.committed_tokens if warmup_tokens is not None else (
        before["ledger_committed"] + engine_tokens)
    if not (committed == expect and engine_tokens == finished_tokens > 0):
        raise RuntimeError(f"ledger committed {committed} (expected {expect}), engine "
                           f"{engine_tokens}, finished requests' tokens {finished_tokens}")
    hbm = bodies["/debug/hbm"]["totals"]
    occ, attr = hbm["occupancy_integral_page_s"], hbm["attributed_page_s"]
    if not (occ > 0 and abs(occ - attr) <= 0.01 * occ):
        raise RuntimeError(f"page observatory: attributed {attr} vs occupancy {occ}")
    steps = [rec for _, rec in aeng.ledger.recent_steps()]
    stalls = sorted(rec["sched_stall"] for rec in steps)
    walls = sum(rec["wall"] for rec in steps)
    buckets = ledger["bucket_seconds"]
    span = sum(buckets.values())
    n = max(1, aeng.steps_total - before["steps"])
    out = {
        "watchdog_compiles": compiles, "ledger_committed_tokens": committed,
        "ledger_warmup_tokens": warmup_tokens, "jobs_tokens": engine_tokens,
        "finished_tokens": finished_tokens, "ledger_steps": ledger["steps"],
        "bucket_seconds": buckets,
        "bucket_share": {k: v / span for k, v in buckets.items()} if span else {},
        "step_wall_s": walls, "limiter": ledger["limiter"],
        "sched_stall_p50_ms": 1e3 * stalls[len(stalls) // 2] if stalls else None,
        "goodput_tok_s": ledger["goodput_tok_s"], "mfu": ledger["mfu"],
        "mfu_peak_tflops": get_settings().chip_peak_tflops,
        "hbm_occupancy_page_s": occ, "hbm_attributed_page_s": attr,
        "hbm_finished_requests": bodies["/debug/hbm"]["replicas"][replica]["attribution"][
            "finished_requests"],
        "obs_us_per_step": 1e6 * (aeng.obs_seconds_total - before["obs_s"]) / n,
        "step_us_mean": 1e6 * (aeng.step_seconds_total - before["step_s"]) / n,
        "timeline_sources": src, "slo_state": bodies["/debug/slo"]["replicas"][0]["state"]
        if bodies["/debug/slo"]["replicas"] else None,
        "admission_hint": bodies["/debug/slo"]["admission_hint"],
    }
    log(f"rag obs: {json.dumps(out)}")
    return out


def phase_rag(cfg, params, device: str = "cuda", index=None, enc=None, passages: int = 8192,
              rows: int = 258048, geometry: dict | None = None,
              prefill_priority: bool = False, llm=None) -> dict:
    """The question-answering loop on the card through the port's entry
    points: the in-process engine built by ``api/__main__`` (its
    ``inprocess_llm`` over the model server's ``build_engine``, settings
    from the environment: the engine phase's geometry, QWEN_MAX_OUTPUT
    set to RAG_MAX_OUTPUT), the agent over the retrieval phase's device
    index (plus repo, module, file and catalog docs), and ``RagApi`` +
    ``RagWorker`` in one process over the memory bus, on localhost.
    Eight jobs posted together (``run_rag_jobs``): code questions, repo
    questions, one whole-repo architecture question (the assembler's
    long-context mode), one cancelled at its first turn, one whose
    ``deadline_ms`` the engine reaps.  Every launch count is set to 0
    just before the jobs and read just after they all reach ``final``.  ``prefill_priority`` sets
    PREFILL_PRIORITY for the engine (``--only options``).  ``llm`` (from
    ``rag_llm``, with the same settings) is used and left open, for the
    split phase; without it the phase builds its own and closes it."""
    import threading

    import torch

    from githubrepostorag_tpu_torch.agent import GraphAgent
    from githubrepostorag_tpu_torch.api.app import RagApi
    from githubrepostorag_tpu_torch.events import (
        MemoryBus, MemoryCancelFlags, MemoryJobQueue, reset_memory_hub)
    from githubrepostorag_tpu_torch.llm import set_llm
    from githubrepostorag_tpu_torch.metrics import (
        DECODE_TOKENS, DEVICE_INDEX_SEARCHES, JOBS_TOTAL, XLA_COMPILES, MeteredLLM, counter_value)
    from githubrepostorag_tpu_torch.retrieval import RetrieverFactory
    from githubrepostorag_tpu_torch.store import set_store
    from githubrepostorag_tpu_torch.worker import RagWorker

    cuda = torch.device(device).type == "cuda"
    t_phase = time.monotonic()
    s = rag_settings(geometry, prefill_priority)
    log(f"rag: QWEN_MAX_OUTPUT={s.qwen_max_output}, CONTEXT_WINDOW={s.context_window}, "
        f"{s.max_num_seqs} rows x {s.kv_num_pages} pages of {s.kv_page_size}, "
        f"PREFILL_PRIORITY={int(s.prefill_priority)}")
    if index is None:
        t0 = time.monotonic()
        index, enc, passages = rag_index(device, rows=rows)
        log(f"rag index: {rows} chunks built in {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    hierarchy = rag_hierarchy(index, enc, rows)
    log(f"rag hierarchy docs {hierarchy} in {time.monotonic() - t0:.1f} s")

    own_llm = llm is None
    warmup_s = None
    if own_llm:
        llm, warmup_s = rag_llm(cfg, params, device)
    engine = llm.engine.engine
    if engine.max_seq_len != s.context_window:
        raise RuntimeError(f"engine max_seq_len {engine.max_seq_len} != CONTEXT_WINDOW")
    set_llm(llm)  # /health reads the engine's stats from the shared LLM
    set_store(index)  # and probes the process-wide store
    agent = GraphAgent(MeteredLLM(llm), RetrieverFactory(index, enc), namespace="default")
    # a fresh hub: the process-wide one's job queue is bound to the event
    # loop of the phase that used it last
    reset_memory_hub()
    bus, flags, queue = MemoryBus(), MemoryCancelFlags(), MemoryJobQueue()
    api = RagApi(bus, flags, queue)
    worker = RagWorker(agent, bus, flags, queue)
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, name="rag-service", daemon=True)
    thread.start()

    def run(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(600)

    # repositories 0.. hold the encoded code chunks; from `short` on every
    # chunk is a one-line stand-in, so one repository's whole text fits the
    # long-context budget
    short = -(-passages // REPO_CHUNKS)
    jobs = rag_jobs(short)
    port = run(api.start("127.0.0.1", 0))
    task = asyncio.run_coroutine_threadsafe(worker.run_forever(), loop)
    stats: dict = {"qwen_max_output": s.qwen_max_output, "engine_warmup_s": warmup_s,
                   "prefill_priority": s.prefill_priority,
                   "hierarchy_docs": hierarchy}
    try:
        free0 = engine._allocator.free_count
        reaps0 = engine.deadline_reaps
        aeng = llm.engine
        obs0 = {"compiles": counter_value(XLA_COMPILES, replica=aeng.replica),
                "ledger_committed": aeng.ledger.snapshot()["tokens"]["committed"],
                "ledger_steps": aeng.ledger.snapshot()["steps"],
                "engine_committed": engine.committed_tokens,
                "decode_tokens": counter_value(DECODE_TOKENS, replica=aeng.replica),
                "obs_s": aeng.obs_seconds_total, "step_s": aeng.step_seconds_total,
                "steps": aeng.steps_total}
        searches0 = {p: counter_value(DEVICE_INDEX_SEARCHES, path=p) for p in ("device", "fallback")}
        jobs0 = {st: counter_value(JOBS_TOTAL, status=st) for st in ("ok", "cancelled", "timeout")}
        reset_launches()
        t0 = time.monotonic()
        done = run_rag_jobs(port, jobs)
        traffic_s = time.monotonic() - t0
        deadline = time.monotonic() + 120
        while engine.has_work() and time.monotonic() < deadline:
            time.sleep(0.05)
        if cuda:
            torch.cuda.synchronize()
        launches = read_launches()

        finished, walls, ttfts, calls = [], [], [], []
        for job in done:
            kinds = [e["event"] for e in job["events"]]
            final = job["events"][-1]["data"]
            q = job["body"]["query"]
            if job["cancelled_at"] is not None:
                if (kinds[-1] != "final" or final.get("cancelled") is not True
                        or job["result"].get("cancelled") is not True):
                    raise RuntimeError(f"cancelled job {q!r}: final {final}")
                continue
            if "deadline_ms" in job["body"]:
                if (kinds[-1] != "error" or "deadline" not in final["error"]
                        or job["result"] != {"answer": "", "sources": [], "error": final["error"]}):
                    raise RuntimeError(f"deadline job {q!r}: events {kinds}, result {job['result']}")
                _, trace, _ = _http(port, "GET", f"/debug/traces/{job['reply']['trace_id']}")
                stats["deadline_job_first_llm_s"] = first_llm_start(trace)
                continue
            if kinds[:2] != ["started", "iteration"] or "error" in kinds or "retrieval" not in kinds:
                raise RuntimeError(f"job {q!r}: events {kinds}")
            if job["result"].get("answer") != final["answer"] or not final["sources"]:
                raise RuntimeError(f"job {q!r}: result {job['result']} vs final {final}")
            status, trace, _ = _http(port, "GET", f"/debug/traces/{job['reply']['trace_id']}")
            if status != 200:
                raise RuntimeError(f"job {q!r}: GET its trace -> {status}")
            names = [sp["name"] for sp in trace["spans"]]
            spans = _spans_by_id(trace)
            want = {"worker.job", "agent.run", "agent.plan", "llm.generate", "engine.prefill",
                    "engine.decode"}
            if not want <= set(names) or not ({"agent.synthesize", "agent.longctx"} & set(names)):
                raise RuntimeError(f"job {q!r}: trace spans {sorted(set(names))}")
            for sp in trace["spans"]:
                if sp["name"] in ("engine.prefill", "engine.decode"):
                    parent = spans.get(sp["parent_id"])
                    if parent is None or parent["name"] != "llm.generate":
                        raise RuntimeError(f"job {q!r}: {sp['name']} outside llm.generate")
            turns = [t["stage"] for t in job["events"][[e["event"] for e in job["events"]]
                                                        .index("retrieval")]["data"]["turns"]]
            finished.append({"query": q, "turns": turns, "llm_calls": names.count("llm.generate"),
                             "sources": len(final["sources"]), "answer_chars": len(final["answer"]),
                             "wall_s": job["wall_s"], **synthesis_ttft(trace)})
            walls.append(job["wall_s"])
            ttfts.append(finished[-1]["ttft_s"])
            calls.append(finished[-1]["llm_calls"])
        longctx = [f for f in finished if "assemble" in f["turns"]]
        if len(finished) != 6 or len(longctx) != 1 or "architecture" not in longctx[0]["query"]:
            raise RuntimeError(f"finished jobs {[(f['query'], f['turns']) for f in finished]}")
        reaped = engine.deadline_reaps - reaps0
        if reaped < 1:
            raise RuntimeError("the deadline job's row was not reaped by the engine")
        searches = {p: counter_value(DEVICE_INDEX_SEARCHES, path=p) - searches0[p]
                    for p in searches0}
        if searches["device"] <= 0 or searches["fallback"] != 0:
            raise RuntimeError(f"index searches in the phase: {searches}")
        jobs_total = {st: counter_value(JOBS_TOTAL, status=st) - jobs0[st] for st in jobs0}
        if jobs_total != {"ok": 6, "cancelled": 1, "timeout": 1}:
            raise RuntimeError(f"rag_jobs_total moved by {jobs_total}")
        a, b = "fused_window_attention", "paged_attention_decode_staged"
        if cuda:
            if launches[a] <= 0 or launches[b] <= 0:
                raise RuntimeError(f"the RAG path launched A {launches[a]}, B {launches[b]} times")
            off = {k: n for k, n in launches.items() if k.split("@")[0] not in (a, b) and n}
            if off:
                raise RuntimeError(f"the RAG path launched kernels it never reaches: {off}")
        if engine.has_work() or engine._allocator.free_count != free0:
            raise RuntimeError(f"pages leaked: {engine._allocator.free_count} free, "
                               f"{free0} before the jobs")
        status, health, _ = _http(port, "GET", "/health")
        if status != 200 or health["status"] != "UP":
            raise RuntimeError(f"/health: {status} {health}")
        llm_health = health["components"]["llm"]["details"]
        if llm_health["free_pages"] != llm_health["total_pages"]:
            raise RuntimeError(f"/health llm: {llm_health}")
        status, metrics, _ = _http(port, "GET", "/metrics")
        if status != 200 or 'rag_jobs_total{status="cancelled"}' not in metrics:
            raise RuntimeError(f"/metrics: {status}")
        if "rag_engine_step_seconds_total" not in metrics or "rag_slo_state" not in metrics:
            raise RuntimeError("/metrics: the ledger's and the SLO plane's series are missing")
        stats["obs"] = rag_obs_check(port, aeng, obs0)
        stats.update({
            "jobs": len(done), "finished": finished, "traffic_wall_s": traffic_s,
            "job_wall_p50_s": percentile(walls, 0.5), "job_wall_p95_s": percentile(walls, 0.95),
            "synth_ttft_p50_s": percentile(ttfts, 0.5),
            "whole_repo_ttft_s": longctx[0]["ttft_s"],
            "synth_prefill_p50_s": percentile([f["prefill_s"] for f in finished], 0.5),
            "llm_calls_per_job": calls, "llm_calls_mean": sum(calls) / len(calls),
            "cancelled_after_events": [j["cancelled_at"] for j in done if j["cancelled_at"]],
            "deadline_reaps": reaped, "index_searches": searches, "jobs_total": jobs_total,
            "kernel_a_launches": launches[a], "kernel_b_launches": launches[b],
            "launches": launches, "terminal_states": [terminal_state(j) for j in done],
        })
    finally:
        worker.stop()
        task.cancel()
        run(api.stop())
        if own_llm:
            llm.close()
        set_llm(None)
        set_store(None)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(30)
        loop.close()
    stats["phase_s"] = time.monotonic() - t_phase
    log(f"rag on {torch.cuda.get_device_name(0) if cuda else 'cpu'}: {json.dumps(stats)}")
    return stats



INGEST_REPO = "smokerepo"
# the prompt kinds of one ingest run, by the first words of each prompt
INGEST_PROMPTS = (("summary", "Summarize"), ("title", "Give a short"), ("keywords", "List up to"),
                  ("file", "Write a 200-300 word"), ("module", "Write a technical summary"),
                  ("repo", "Write a comprehensive"), ("readme_judge", "Is this README"),
                  ("catalog", "Describe"))


def _py_source(rng, n_funcs: int, tag: str) -> str:
    """A Python module of ``n_funcs`` functions over the smoke identifiers."""
    parts = [f'"""The {tag} module."""', "import os\nfrom typing import Any"]
    for i in range(n_funcs):
        a, b = rng.choice(_IDENTS, 2)
        body = []
        for _ in range(int(rng.integers(5, 12))):
            x, y, z = rng.choice(_IDENTS, 3)
            body.append(f"    {x} = self.{y}.{z}({x}, {int(rng.integers(0, 99))})  # {y} {z}")
        parts.append(f"def {tag}_{a}_{b}_{i}(self, {a}, limit={int(rng.integers(1, 999))}):\n"
                     + "\n".join(body) + f"\n    return {b}")
    return "\n\n\n".join(parts) + "\n"


def _js_source(rng, n_funcs: int, tag: str) -> str:
    parts = ["const express = require('express');"]
    for i in range(n_funcs):
        a, b = rng.choice(_IDENTS, 2)
        body = [f"  const {x} = {y}.{z}({int(rng.integers(0, 99))});"
                for x, y, z in (rng.choice(_IDENTS, 3) for _ in range(int(rng.integers(3, 8))))]
        parts.append(f"function {tag}{a.title()}{b.title()}{i}(req, res) {{\n" + "\n".join(body)
                     + f"\n  return res.json({a});\n}}")
    return "\n\n".join(parts) + "\n"


def ingest_tree(root) -> dict[str, str]:
    """A synthetic repository written under ``root``, the same on every run
    (seeded): three top-level modules (core/, api/, docs/) and a root
    README; Python and JavaScript sources, Markdown, one notebook with a
    setup cell and a log-heavy output, and one image preprocess skips.
    Returns path -> text of every file written."""
    import os

    rng = np.random.default_rng(SEED + 41)
    readme = ("# smokerepo\n\nA code-RAG service in three modules. `core/` holds the index, "
              "the store and the query planner; `api/` serves HTTP routes over them; `docs/` "
              "explains deployment.\n\n" + "\n".join(
                  f"- {a}: the {b} {c} path" for a, b, c in (rng.choice(_IDENTS, 3)
                                                           for _ in range(18))))
    notebook = json.dumps({"nbformat": 4, "cells": [
        {"cell_type": "markdown", "source": ["# Index analysis\n", "Recall of the store."]},
        {"cell_type": "code", "source": "!pip install pandas\n%matplotlib inline", "outputs": []},
        {"cell_type": "code", "source": "df = load_index()\ndf.describe()", "outputs": [
            {"output_type": "stream",
             "text": "2026-01-01 10:00:00 INFO loading shard\n" * 40}]},
        {"cell_type": "code", "source": ["recall = evaluate(df)\n", "print(recall)"],
         "outputs": [{"output_type": "stream", "text": "recall@10 = 0.91\n"}]},
    ]})
    guide = "# Deployment guide\n\n" + "\n\n".join(
        f"## Step {i}\n\n" + " ".join(rng.choice(_IDENTS, 60)) for i in range(9))
    files = {
        "README.md": readme,
        "core/index.py": _py_source(rng, 11, "index"),
        "core/store.py": _py_source(rng, 10, "store"),
        "core/query.py": _py_source(rng, 11, "query"),
        "api/server.py": _py_source(rng, 10, "server"),
        "api/routes.py": _py_source(rng, 11, "routes"),
        "api/client.js": _js_source(rng, 6, "client"),
        "api/views.js": _js_source(rng, 5, "views"),
        "docs/guide.md": guide,
        "docs/deploy.md": "# Deploy\n\n" + " ".join(rng.choice(_IDENTS, 150)),
        "docs/analysis.ipynb": notebook,
        "docs/diagram.png": "\\x89PNG not text",
    }
    for rel, text in files.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as fh:
            fh.write(text)
    return files


def ingest_expectations(root) -> dict:
    """What one ingest of the tree at ``root`` must write and ask, computed
    on the host with the port's readers, preprocess and chunker: the kept
    files, chunks, modules (top directories of kept files; a root file's is
    "(root)") and the LLM prompts of each kind the tree implies."""
    from githubrepostorag_tpu_torch.ingest.chunker import split_document
    from githubrepostorag_tpu_torch.ingest.hierarchy import top_directory
    from githubrepostorag_tpu_torch.ingest.preprocess import prepare_repo_documents
    from githubrepostorag_tpu_torch.ingest.sources import LocalRepoReader

    docs = LocalRepoReader(root).load()
    prepared = prepare_repo_documents(docs)
    chunks = {d.path: len(split_document(d.text, d.metadata.get("language"))) for d in prepared}
    files = [p for p, n in chunks.items() if n]
    modules = sorted({top_directory(p) for p in files})
    n = sum(chunks.values())
    return {"source_docs": len(docs), "files": files, "chunks": n, "modules": modules,
            "prompts": {"summary": n, "title": n, "keywords": n, "file": len(files),
                        "module": len(modules), "repo": 1, "readme_judge": 1}}


class CountingLLM:
    """The LLM protocol over an ``InProcessLLM``, recording every call: its
    prompts' kinds (``INGEST_PROMPTS``), its max_tokens, its wall time, and
    the tokens its engine committed meanwhile (the calls come one at a
    time, so the engine's count moves for this call alone)."""

    def __init__(self, inner, engine) -> None:
        self.inner, self.engine, self.calls = inner, engine, []

    @staticmethod
    def kind(prompt: str) -> str:
        return next((k for k, head in INGEST_PROMPTS if prompt.startswith(head)), "other")

    def _record(self, prompts, max_tokens, call):
        t0, tok0 = time.monotonic(), self.engine.committed_tokens
        out = call()
        self.calls.append({"kinds": [self.kind(p) for p in prompts], "max_tokens": max_tokens,
                           "s": time.monotonic() - t0,
                           "generated": self.engine.committed_tokens - tok0})
        return out

    def complete(self, prompt, **kw):
        return self._record([prompt], kw.get("max_tokens"),
                            lambda: self.inner.complete(prompt, **kw))

    def complete_batch(self, prompts, **kw):
        return self._record(list(prompts), kw.get("max_tokens"),
                            lambda: self.inner.complete_batch(prompts, **kw))

    def stream_complete(self, prompt, **kw):
        return self.inner.stream_complete(prompt, **kw)


def repo_chunk_nodes() -> tuple[list[str], list]:
    """One repository's ``REPO_CHUNKS`` chunk nodes: the retrieval phase's
    code passages with the scope keys of ``chunk_metadata``, enriched by
    ``enrich_nodes`` with a scripted ``FakeLLM`` (a summary, a title and
    keywords each, no engine).  Returns (texts, nodes)."""
    import re

    from githubrepostorag_tpu_torch.ingest.extractors import enrich_nodes
    from githubrepostorag_tpu_torch.ingest.types import Node
    from githubrepostorag_tpu_torch.llm import FakeLLM

    texts = code_passages(np.random.default_rng(SEED + 53), REPO_CHUNKS)
    nodes = [Node(text, {**chunk_metadata(i), "language": "python", "span": f"{i % 8 * 40 + 1}"})
             for i, text in enumerate(texts)]

    def name(prompt):
        return re.search(r"def (\w+)", prompt).group(1)

    llm = FakeLLM({
        r"Summary:$": lambda p: f"{name(p)} reads its arguments, updates the store and "
                                f"returns the result. It is called once a batch.",
        r"Title:$": lambda p: f"The {name(p).replace('_', ' ')} helper",
        r"Keywords:$": lambda p: ", ".join(name(p).split("_")[:3] + ["python", "store"]),
    })
    enrich_nodes(llm, nodes)
    if not all("keywords" in n.metadata for n in nodes):
        raise RuntimeError("the scripted extractors left chunk nodes unenriched")
    return texts, nodes


def repo_vector_write(enc, device: str = "cuda", runs: int = 2) -> dict:
    """The vector write at one repository's size: ``REPO_CHUNKS`` chunk
    nodes (the retrieval phase's code passages, the scope keys of
    ``chunk_metadata``), enriched by ``enrich_nodes`` with a scripted
    ``FakeLLM`` (a summary, a title and keywords each, no engine), written
    by ``write_nodes_per_scope`` through ``enc`` into a fresh device-indexed
    memory store, ``runs`` times: each run's seconds and passages/s, and the
    first search's seconds (it copies the new rows to the card); then the
    encoder's seconds alone on the same batches.  Raises
    unless every row reaches the host store and the device index."""
    import torch

    from githubrepostorag_tpu_torch.config import get_settings
    from githubrepostorag_tpu_torch.ingest.vector_write import WRITE_BATCH, write_nodes_per_scope
    from githubrepostorag_tpu_torch.retrieval import DeviceIndexedStore
    from githubrepostorag_tpu_torch.store.memory import MemoryVectorStore

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    s = get_settings()
    texts, nodes = repo_chunk_nodes()
    table = s.scope_tables["chunk"]
    out = []
    for _ in range(runs):
        store = DeviceIndexedStore(MemoryVectorStore(), k_bucket=s.device_index_k_bucket,
                                   max_wave=s.retrieval_max_wave, device=device)
        sync()
        t0 = time.monotonic()
        written = write_nodes_per_scope({"chunk": nodes}, store=store, encoder=enc)
        sync()
        wall = time.monotonic() - t0
        # the device copy takes the dirty rows at the first search
        t0 = time.monotonic()
        store.search(table, enc.encode([texts[0]], kind="query")[0], 8)
        sync()
        sync_s = time.monotonic() - t0
        rows = store.health()["device_index"].get(table, {}).get("rows")
        if written != {"chunk": REPO_CHUNKS} or store.inner.count(table) != REPO_CHUNKS \
                or rows != REPO_CHUNKS:
            raise RuntimeError(f"repository-size vector write: {written}, host "
                               f"{store.inner.count(table)}, device {rows} rows")
        out.append({"s": wall, "passages_per_s": REPO_CHUNKS / wall,
                    "first_search_s": sync_s})
        del store
    # then the encoder alone on the same batches of WRITE_BATCH
    sync()
    t0 = time.monotonic()
    for start in range(0, REPO_CHUNKS, WRITE_BATCH):
        enc.encode([n.text for n in nodes[start:start + WRITE_BATCH]], kind="passage")
    sync()
    encode_s = time.monotonic() - t0
    stats = {"passages": REPO_CHUNKS, "encode_s": encode_s,
             "encode_passages_per_s": REPO_CHUNKS / encode_s, "runs": out}
    log(f"vector write at one repository's size: {json.dumps(stats)}")
    return stats


def phase_ingest(cfg, params, enc=None, device: str = "cuda", geometry: dict | None = None,
                 enc_cfg=None) -> dict:
    """Ingest on the card through the CLI's entry point: the synthetic tree
    (``ingest_tree``) read by ``LocalRepoReader``, the extractors, catalog
    and hierarchy summaries through ``InProcessLLM.complete_batch`` on the
    engine ``api/__main__.inprocess_llm`` builds (the engine phase's
    geometry, the byte tokenizer, the 7B tree), the vector write through
    the retrieval phase's encoder into ``get_store()``: the memory store in
    the device index (STORE_BACKEND=memory, DEVICE_INDEX=auto), DATA_DIR
    and STORE_PATH in a temp dir.  Every launch count is set to 0 just
    before ``ingest.__main__.main`` and read just after.  Then one code
    question about a function of the tree through ``RagApi`` + ``RagWorker``
    over the ingested store."""
    import logging
    import os
    import tempfile
    import threading

    import torch

    from githubrepostorag_tpu_torch import config
    from githubrepostorag_tpu_torch.agent import GraphAgent
    from githubrepostorag_tpu_torch.api.__main__ import inprocess_llm
    from githubrepostorag_tpu_torch.api.app import RagApi
    from githubrepostorag_tpu_torch.embedding import set_encoder
    from githubrepostorag_tpu_torch.events import (
        MemoryBus, MemoryCancelFlags, MemoryJobQueue, reset_memory_hub)
    from githubrepostorag_tpu_torch.ingest.__main__ import main as ingest_main
    from githubrepostorag_tpu_torch.llm import set_llm
    from githubrepostorag_tpu_torch.resilience.policy import priority_scope
    from githubrepostorag_tpu_torch.metrics import MeteredLLM
    from githubrepostorag_tpu_torch.retrieval import DeviceIndexedStore, RetrieverFactory
    from githubrepostorag_tpu_torch.serving.tokenizer import ByteTokenizer
    from githubrepostorag_tpu_torch.store import get_store, reset_store
    from githubrepostorag_tpu_torch.store.memory import MemoryVectorStore
    from githubrepostorag_tpu_torch.worker import RagWorker

    cuda = torch.device(device).type == "cuda"
    t_phase = time.monotonic()
    if enc is None:
        enc, _ = e5_encoder(device, enc_cfg)
    tmp = tempfile.TemporaryDirectory(prefix="ingest_smoke_")
    root = os.path.join(tmp.name, INGEST_REPO)
    data_dir, store_dir = os.path.join(tmp.name, "data"), os.path.join(tmp.name, "store")
    os.makedirs(data_dir)
    files = ingest_tree(root)
    want = ingest_expectations(root)
    log(f"ingest tree: {len(files)} files written, {len(want['files'])} kept, "
        f"{want['chunks']} chunks, modules {want['modules']}")
    os.environ.update(geometry or ENGINE_GEOMETRY, QWEN_MAX_OUTPUT=str(RAG_MAX_OUTPUT),
                      LLM_BACKEND="inprocess", STORE_BACKEND="memory", DEVICE_INDEX="auto",
                      LIVE_INDEX="off", DATA_DIR=data_dir, STORE_PATH=store_dir,
                      PREFILL_PRIORITY="0", PREFILL_WIDTHS="1")
    s = config.reload_settings()
    reset_store()
    t0 = time.monotonic()
    raw_llm = inprocess_llm(s, params, cfg, ByteTokenizer(), device)
    warmup_s = time.monotonic() - t0
    engine = raw_llm.engine.engine
    llm = CountingLLM(raw_llm, engine)
    prompt_tokens = [0]
    ids_of = raw_llm._prompt_ids

    def counted_ids(prompt, system):
        ids = ids_of(prompt, system)
        prompt_tokens[0] += len(ids)
        return ids

    raw_llm._prompt_ids = counted_ids
    set_llm(llm)
    set_encoder(enc)
    # an extractor stage that raises logs this warning and leaves its nodes as they were
    stage_failures: list[str] = []

    class StageFailures(logging.Handler):
        def emit(self, record):
            if "failed" in record.getMessage():
                stage_failures.append(record.getMessage())

    handler = StageFailures(logging.WARNING)
    ext_logger = logging.getLogger("githubrepostorag_tpu_torch.ingest.extractors")
    ext_logger.addHandler(handler)
    loop = thread = None
    stats: dict = {"engine_warmup_s": warmup_s}
    try:
        admitted0, committed0 = engine.requests_admitted, engine.committed_tokens
        prefill0 = engine.prefill_tokens
        reset_launches()
        t0 = time.monotonic()
        printed = io.StringIO()
        # the CLI prints the run's record; its LLM calls are batch-class
        # work: in a deployment the ingest pod is not the API pod, and here
        # its 65 queued prompts would otherwise burn the interactive class's
        # TTFT budget on the engine the phase's RAG job shares, and the
        # API's SLO plane would shed that job
        with contextlib.redirect_stdout(printed), priority_scope("batch"):
            rc = ingest_main(["--local", root, "--repo", INGEST_REPO,
                              *([] if cuda else ["--device", "cpu"])])
        ingest_s = time.monotonic() - t0
        if rc != 0:
            raise RuntimeError(f"the ingest CLI returned {rc}")
        deadline = time.monotonic() + 60
        while engine.has_work() and time.monotonic() < deadline:
            time.sleep(0.05)
        if cuda:
            torch.cuda.synchronize()
        launches = read_launches()
        store = get_store()
        if not isinstance(store, DeviceIndexedStore):
            raise RuntimeError(f"get_store() built {type(store).__name__}, not the device index")
        tables = s.scope_tables
        written = {scope: store.count(tables[scope]) for scope in tables}
        expect = {"catalog": 1, "repo": 1, "module": len(want["modules"]),
                  "file": len(want["files"]), "chunk": want["chunks"]}
        if written != expect:
            raise RuntimeError(f"rows written per scope {written}, the tree implies {expect}")
        records = [json.loads(line) for line in
                   open(os.path.join(data_dir, "ingest_runs.jsonl")).read().splitlines()]
        if (len(records) != 1 or records[0]["repo"] != INGEST_REPO
                or records[0]["written"] != expect):
            raise RuntimeError(f"ingest_runs.jsonl: {records}")
        record = records[0]
        if json.loads(printed.getvalue())["run_id"] != record["run_id"]:
            raise RuntimeError("the CLI printed another run than ingest_runs.jsonl holds")
        if not os.path.exists(os.path.join(data_dir, ".ingest_complete")):
            raise RuntimeError(".ingest_complete was not written")
        # the LLM calls the tree implies, and the engine served each of them
        kinds: dict[str, int] = {}
        for call in llm.calls:
            for k in call["kinds"]:
                kinds[k] = kinds.get(k, 0) + 1
        catalog_calls = kinds.pop("catalog", 0)
        if kinds != want["prompts"] or catalog_calls > 2:
            raise RuntimeError(f"LLM prompts by kind {kinds} (+{catalog_calls} catalog), "
                               f"the tree implies {want['prompts']}")
        n_prompts = sum(len(c["kinds"]) for c in llm.calls)
        admitted = engine.requests_admitted - admitted0
        if admitted != n_prompts:
            raise RuntimeError(f"the engine admitted {admitted} requests for {n_prompts} prompts")
        if stage_failures:
            raise RuntimeError(f"extractor stages took their exception path: {stage_failures}")
        # the device index against the host store: rows per table, rankings
        dev_rows = {t: h["rows"] for t, h in store.health()["device_index"].items()}
        for table in tables.values():
            if dev_rows.get(table) != store.inner.count(table):
                raise RuntimeError(f"{table}: {dev_rows.get(table)} device rows, host "
                                   f"{store.inner.count(table)}")
        rng = np.random.default_rng(SEED + 43)
        idents = sorted({w for text in files.values() for w in text.replace("(", " ").split()
                         if w.count("_") >= 2 and w.isidentifier()})
        queries = [f"{q} {a}" for q, a in zip(rng.choice(idents, 8), rng.choice(_IDENTS, 8))]
        qv = enc.encode(queries, kind="query")
        for table, k in ((tables["chunk"], 8), (tables["file"], 5), (tables["module"], 3)):
            for v in qv:
                same_ranking(store.inner.search(table, v, k), store.search(table, v, k))
        saved = MemoryVectorStore(persist_dir=store_dir)
        if {t: saved.count(t) for t in saved.tables()} != {t: store.count(t)
                                                           for t in store.tables()}:
            raise RuntimeError("the saved store reloads with other counts")
        chunk_docs = store.inner.find_by_metadata(tables["chunk"], {}, limit=10_000)
        enriched = {key: sum(1 for d in chunk_docs if key in d.metadata)
                    for key in ("summary", "title", "keywords")}
        a, b = "fused_window_attention", "paged_attention_decode_staged"
        if cuda:
            if launches[a] <= 0 or launches[b] <= 0:
                raise RuntimeError(f"ingest launched A {launches[a]}, B {launches[b]} times")
            off = {k: n for k, n in launches.items() if k.split("@")[0] not in (a, b) and n}
            if off:
                raise RuntimeError(f"ingest launched kernels it never reaches: {off}")
        if engine.has_work() or engine._allocator.free_count != engine._allocator.num_pages:
            raise RuntimeError(f"KV pages held after ingest: {engine._allocator.free_count} free "
                               f"of {engine._allocator.num_pages}")
        timings = record["timings"]
        ext = [c for c in llm.calls if c["kinds"][0] in ("summary", "title", "keywords")]
        ext_s = sum(c["s"] for c in ext)
        generated = engine.committed_tokens - committed0
        stats.update({
            "files_written": len(files), "files": len(want["files"]), "chunks": want["chunks"],
            "modules": want["modules"], "written": written, "llm_calls": n_prompts,
            "llm_calls_by_kind": {**kinds, "catalog": catalog_calls},
            "enriched_chunks": enriched, "timings": timings,
            "total_s": record["total_seconds"], "cli_wall_s": ingest_s,
            "prompt_tokens": prompt_tokens[0], "prefill_tokens": engine.prefill_tokens - prefill0,
            "generated_tokens": generated,
            "extractor_prompts_per_s": sum(len(c["kinds"]) for c in ext) / ext_s,
            "extractor_generated_tok_per_s": sum(c["generated"] for c in ext) / ext_s,
            "generated_tok_per_s": generated / sum(c["s"] for c in llm.calls),
            "kernel_a_launches": launches[a], "kernel_b_launches": launches[b],
            "kernel_a_launches_by_window": {k.split("@S")[1]: n for k, n in launches.items()
                                            if k.startswith(a + "@S") and n},
            "launches": launches, "device_rows": dev_rows,
        })
        log(f"ingest: {json.dumps(stats)}")

        # ingest -> retrieve -> generate: one code question over this store
        fn = next(w for w in idents if w.startswith("index_"))
        agent = GraphAgent(MeteredLLM(raw_llm), RetrieverFactory(store, enc), namespace="default")
        reset_memory_hub()  # the rag phase's hub is bound to its own loop
        bus, flags, queue = MemoryBus(), MemoryCancelFlags(), MemoryJobQueue()
        api = RagApi(bus, flags, queue)
        worker = RagWorker(agent, bus, flags, queue)
        loop = asyncio.new_event_loop()
        thread = threading.Thread(target=loop.run_forever, name="ingest-rag", daemon=True)
        thread.start()
        port = asyncio.run_coroutine_threadsafe(api.start("127.0.0.1", 0), loop).result(60)
        task = asyncio.run_coroutine_threadsafe(worker.run_forever(), loop)
        try:
            reset_launches()
            job = rag_job(port, {"query": f"what does the function {fn} return in repo: "
                                          f"{INGEST_REPO}?"})
            if cuda:
                torch.cuda.synchronize()
            rag_launches = read_launches()
        finally:
            worker.stop()
            task.cancel()
            asyncio.run_coroutine_threadsafe(api.stop(), loop).result(60)
        final = job["events"][-1]
        sources = final["data"].get("sources", []) if final["event"] == "final" else []
        paths = {src.get("file_path") for src in sources}
        if final["event"] != "final" or not sources or not paths & set(want["files"]):
            raise RuntimeError(f"RAG job over the ingested store: {final['event']}, "
                               f"source files {sorted(p for p in paths if p)}")
        if cuda and (rag_launches[a] <= 0 or rag_launches[b] <= 0):
            raise RuntimeError(f"the RAG job launched A {rag_launches[a]}, B {rag_launches[b]}")
        stats.update({"rag_question": job["body"]["query"], "rag_job_wall_s": job["wall_s"],
                      "rag_sources": len(sources),
                      "rag_source_files": sorted(p for p in paths if p in want["files"])})
        # the tree's vector write is 34 rows; the rate at one repository's size
        stats["vector_write_repo"] = repo_vector_write(enc, device)
    finally:
        ext_logger.removeHandler(handler)
        if loop is not None:
            loop.call_soon_threadsafe(loop.stop)
            thread.join(30)
            loop.close()
        raw_llm.close()
        set_llm(None)
        set_encoder(None)
        reset_store()
        for name in ("STORE_BACKEND", "DEVICE_INDEX", "LIVE_INDEX", "DATA_DIR", "STORE_PATH",
                     "PREFILL_PRIORITY", "PREFILL_WIDTHS"):
            os.environ.pop(name, None)
        config.reload_settings()
        tmp.cleanup()
    stats["phase_s"] = time.monotonic() - t_phase
    log(f"ingest on {torch.cuda.get_device_name(0) if cuda else 'cpu'}: {json.dumps(stats)}")
    return stats


# ------------------------------------------------------------------ split --

SPLIT_STOP_S = 5  # MiniRedis.stop() once every connection is closed
SPLIT_POD_STOP_S = 30  # a pod's exit after SIGTERM
NATIVE_TOL = 1e-6  # native vs memory store scores


class Pod:
    """An entry point run as a subprocess (a pod of the split deployment),
    its output collected line by line by a thread."""

    def __init__(self, name: str, args: list[str], env: dict) -> None:
        import threading
        from pathlib import Path

        self.name = name
        self.t0 = time.monotonic()
        self.proc = subprocess.Popen([sys.executable, *args], env=env,
                                     cwd=Path(__file__).resolve().parent,
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.lines: list[str] = []
        self.arrived: list[float] = []  # seconds from the start, a line each
        self._cv = threading.Condition()
        self._reader = threading.Thread(target=self._drain, name=f"{name}-output", daemon=True)
        self._reader.start()

    def _drain(self) -> None:
        for line in self.proc.stdout:
            with self._cv:
                self.lines.append(line.rstrip("\n"))
                self.arrived.append(time.monotonic() - self.t0)
                self._cv.notify_all()
        with self._cv:
            self._cv.notify_all()

    def tail(self, n: int = 20) -> str:
        with self._cv:
            return "\n".join(self.lines[-n:])

    def wait_for_line(self, text: str, timeout: float) -> float:
        """Seconds from the start until the first line holding ``text``
        arrived; raises if the pod exits or ``timeout`` passes first."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                hit = next((i for i, line in enumerate(self.lines) if text in line), None)
                if hit is not None:
                    return self.arrived[hit]
                left = deadline - time.monotonic()
                if self.proc.poll() is not None or left <= 0:
                    raise RuntimeError(f"{self.name} pod: no {text!r} line (exit "
                                       f"{self.proc.poll()}):\n{chr(10).join(self.lines[-20:])}")
                self._cv.wait(min(left, 0.5))

    def terminate(self, timeout: float) -> tuple[int, float]:
        """SIGTERM, then (exit code, seconds to exit)."""
        import signal

        t0 = time.monotonic()
        self.proc.send_signal(signal.SIGTERM)
        rc = self.proc.wait(timeout)
        self._reader.join(5)
        return rc, time.monotonic() - t0

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(30)


def stand_in(name: str):
    """``tests/<name>.py`` loaded from its path: an installed package may
    own the top-level name ``tests``."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent / "tests" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"chip_smoke_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def serve_stand_ins() -> None:
    """The split phase's stand-ins in a process of their own, so that their
    Python work never holds the engine process's interpreter lock:
    MiniRedis on an asyncio loop, the CQL stand-in on its threads.  Prints
    both ports; on SIGTERM stops MiniRedis, bounded by SPLIT_STOP_S, and
    prints how long that took (or that it timed out: a client left a
    connection open)."""
    import signal

    redis = stand_in("miniredis").MiniRedis()
    cass = stand_in("torch_minicassandra").MiniCassandra()

    async def serve():
        stop = asyncio.Event()
        asyncio.get_running_loop().add_signal_handler(signal.SIGTERM, stop.set)
        print(f"stand-ins redis={await redis.start()} cassandra={cass.start()}", flush=True)
        await stop.wait()
        t0 = time.monotonic()
        try:
            await asyncio.wait_for(redis.stop(), SPLIT_STOP_S)
            print(f"redis stopped in {time.monotonic() - t0} s", flush=True)
        except TimeoutError:
            print("redis stop timed out", flush=True)
        cass.stop()

    asyncio.run(serve())


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _maps_libcuda(pid: int) -> bool | None:
    """Whether the process has the CUDA driver library mapped (None where
    /proc does not say)."""
    try:
        with open(f"/proc/{pid}/maps") as fh:
            return "libcuda.so" in fh.read()
    except OSError:
        return None


def stream_missed(emitted: list[str], events: list[dict]) -> int:
    """Frames of a job the SSE stream missed: the worker's emitted events
    up to the one the stream ended on, less those the stream read.  Raises
    unless what it read is that sequence's tail (pub/sub has no replay, so
    a stream that subscribes after the job started loses its head, never
    a frame in between)."""
    got = [e["event"] for e in events]
    if not got or got[-1] not in emitted:
        raise RuntimeError(f"stream ended on {got[-1:]}, the worker emitted {emitted}")
    upto = emitted[:len(emitted) - emitted[::-1].index(got[-1])]
    if upto[len(upto) - len(got):] != got:
        raise RuntimeError(f"the stream read {got}, not a tail of the emitted {upto}")
    return len(upto) - len(got)


def native_store_check(docs: list, enc, queries: list[str], device: str) -> dict:
    """STORE_BACKEND=native with DEVICE_INDEX=off through the factory: the
    native store over ``docs`` (built into the port's _build/) against the
    memory store: every query with and without a module filter ranked
    alike (scores within NATIVE_TOL, ids in order across every clearer
    gap, exact ties in insertion order); query p50 of both."""
    import os

    from githubrepostorag_tpu_torch import config
    from githubrepostorag_tpu_torch.store import factory
    from githubrepostorag_tpu_torch.store.memory import MemoryVectorStore
    from githubrepostorag_tpu_torch.store.native import NativeVectorStore

    table = config.get_settings().scope_tables["chunk"]
    saved = {k: os.environ.get(k) for k in ("STORE_BACKEND", "DEVICE_INDEX", "STORE_PATH")}
    os.environ.update(STORE_BACKEND="native", DEVICE_INDEX="off", STORE_PATH="")
    config.reload_settings()
    factory.reset_store()
    try:
        native = factory.get_store(device=device)
        if type(native) is not NativeVectorStore or native.backend != "native":
            raise RuntimeError(f"STORE_BACKEND=native gave {type(native).__name__} "
                               f"({getattr(native, 'backend', None)})")
        memory = MemoryVectorStore()
        for store in (native, memory):
            store.upsert(table, docs)
        order = {d.doc_id: i for i, d in enumerate(docs)}
        qvecs = enc.encode(queries, kind="query")
        times = {"native": [], "memory": []}
        for q, vec in zip(queries, qvecs):
            for flt in (None, {"module": docs[order_hint(q, len(docs))].metadata["module"]}):
                hits = {}
                for name, store in (("native", native), ("memory", memory)):
                    t0 = time.perf_counter()
                    hits[name] = store.search(table, vec, 10, flt)
                    times[name].append(time.perf_counter() - t0)
                if not hits["memory"]:
                    raise RuntimeError(f"no hits for {q!r} ({flt})")
                same_ranking(hits["memory"], hits["native"], NATIVE_TOL)
                for a, b in zip(hits["native"], hits["native"][1:]):
                    if a.score == b.score and order[a.doc.doc_id] > order[b.doc.doc_id]:
                        raise RuntimeError(f"tied native hits out of insertion order: "
                                           f"{a.doc.doc_id}, {b.doc.doc_id}")
        return {"backend": native.backend, "rows": len(docs), "queries": len(times["native"]),
                "native_query_p50_ms": percentile(times["native"], 0.5) * 1e3,
                "memory_query_p50_ms": percentile(times["memory"], 0.5) * 1e3}
    finally:
        factory.reset_store()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        config.reload_settings()


def order_hint(query: str, n: int) -> int:
    """A row whose module filters ``query``'s search (stable across runs)."""
    return sum(map(ord, query)) % n


def phase_split(cfg, llm, rag: dict, enc, device: str = "cuda", rows: int = 258048,
                passages: int = 8192, worker_ckpt: tuple | None = None) -> dict:
    """The split deployment on the card: the reference's topology of a
    rag-api pod and rag-worker pods joined by Redis, vectors in Cassandra.

    Stand-ins on localhost, in a process of their own
    (``serve_stand_ins``): ``tests/miniredis.py`` (RESP2) and
    ``tests/torch_minicassandra.py`` (CQL native protocol v4 on the port's
    codec), Python servers whose rates say nothing of Redis or Cassandra.
    The rag phase's repo, module, file and catalog docs and one
    repository's chunk rows (``repo_chunk_nodes`` through
    ``write_nodes_per_scope`` and ``enc``, repo0) are written into the CQL
    stand-in by the port's ``CassandraVectorStore``, and the one-line
    chunks of the repository the whole-repo question reads (as in the rag
    phase's index, so that it fits the long-context budget); a device
    index over a second ``CassandraVectorStore`` seeds itself from them.

    The API pod is ``python -m githubrepostorag_tpu_torch.api --redis
    --no-worker`` (no engine: the card's free memory must not drop by a
    context).  Worker (a) is ``RagWorker`` in this process over
    ``RedisBus`` / ``RedisCancelFlags`` / ``RedisJobQueue``, the agent over
    ``llm`` (the rag phase's engine) and the Cassandra-seeded device index.
    The rag phase's eight jobs go to the API pod at once; every stream is
    read through the API pod (the frames it missed counted against what
    the worker emitted), every result through GET /rag/jobs/{id}/result;
    terminal states must equal the rag phase's, the cancel must travel as
    the Redis flag, A and B must launch and nothing else, no page may
    leak, every search must run on the device.  Worker (b) is the worker
    pod's own entry point, ``python -m githubrepostorag_tpu_torch.worker``
    over ``worker_ckpt`` (a (cfg, params) written as a checkpoint with a
    byte tokenizer; the load phase's full-width 2-layer tree by default)
    with STORE_BACKEND=cassandra and DEVICE_INDEX=on: two jobs to final,
    /metrics, exit 0 on SIGTERM, then MiniRedis.stop() within
    SPLIT_STOP_S (no connection left open).  Last, the native store
    against the memory store over the same chunk rows."""
    import os
    import shutil
    import tempfile
    import threading
    from collections import defaultdict
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    import torch

    from githubrepostorag_tpu_torch import config, kernels
    from githubrepostorag_tpu_torch.agent import GraphAgent
    from githubrepostorag_tpu_torch.api.__main__ import close_events
    from githubrepostorag_tpu_torch.events.redis import RedisBus, RedisCancelFlags, RedisJobQueue
    from githubrepostorag_tpu_torch.ingest.vector_write import write_nodes_per_scope
    from githubrepostorag_tpu_torch.llm import set_llm
    from githubrepostorag_tpu_torch.metrics import (
        DEVICE_INDEX_SEARCHES, JOBS_TOTAL, MeteredLLM, counter_value)
    from githubrepostorag_tpu_torch.obs import get_recorder
    from githubrepostorag_tpu_torch.retrieval import DeviceIndexedStore, RetrieverFactory
    from githubrepostorag_tpu_torch.store.base import Doc
    from githubrepostorag_tpu_torch.store.cassandra import CassandraVectorStore
    from githubrepostorag_tpu_torch.worker import RagWorker

    cuda = torch.device(device).type == "cuda"
    t_phase = time.monotonic()
    s = config.get_settings()
    tables = s.scope_tables

    class CountingBus(RedisBus):
        """The worker's bus, noting each job's emitted events in order."""

        def __init__(self, url: str) -> None:
            super().__init__(url)
            self.emitted: dict[str, list[str]] = defaultdict(list)

        async def emit(self, job_id: str, event: str, data: dict) -> None:
            await super().emit(job_id, event, data)
            self.emitted[job_id].append(event)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, name="split-worker", daemon=True)
    thread.start()

    def run(coro, timeout=600):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout)

    servers = Pod("stand-ins", ["-c", "import chip_smoke; chip_smoke.serve_stand_ins()"],
                  dict(os.environ))
    pods: list[Pod] = [servers]
    servers.wait_for_line("stand-ins redis=", 60)
    ports = dict(kv.split("=") for kv in next(
        ln for ln in servers.lines if ln.startswith("stand-ins ")).split()[1:])
    url, cass_port = f"redis://127.0.0.1:{ports['redis']}/0", int(ports["cassandra"])
    dim = int(enc.encode(["dimension"], kind="query").shape[1])
    cass_env = {"STORE_BACKEND": "cassandra", "CASSANDRA_HOST": "127.0.0.1",
                "CASSANDRA_PORT": str(cass_port), "REDIS_URL": url, "LOG_FORMAT": "plain",
                "EMBED_DIM": str(dim)}
    dev_flag = [] if cuda else ["--device", "cpu"]
    sessions = []
    stats: dict = {"cassandra_stand_in": "tests/torch_minicassandra.py (a Python server)",
                   "redis_stand_in": "tests/miniredis.py (a Python server)",
                   "stand_ins_process": "separate"}
    worker_a = None
    ckpt = None
    try:
        # ---- seed the CQL stand-in through the port's Cassandra store
        def cassandra():
            store = CassandraVectorStore(["127.0.0.1"], port=cass_port,
                                         keyspace=s.cassandra_keyspace, embed_dim=dim)
            sessions.append(store._session)
            return store

        seed = cassandra()
        docs = rag_hierarchy_docs(enc, rows)
        short = -(-passages // REPO_CHUNKS)  # the whole-repo question's repository
        block = np.random.default_rng(SEED + 61).standard_normal((REPO_CHUNKS, dim))
        block = (block / np.linalg.norm(block, axis=1, keepdims=True)).astype(np.float32)
        first = short * REPO_CHUNKS
        docs["chunk"] = [Doc(f"c{r:06d}", f"chunk {r}", chunk_metadata(r), block[r - first])
                         for r in range(first, first + REPO_CHUNKS)]
        texts, nodes = repo_chunk_nodes()
        t0 = time.monotonic()
        written = write_nodes_per_scope({"chunk": nodes}, store=seed, encoder=enc)
        sync()
        chunk_s = time.monotonic() - t0
        chunk_docs = seed.find_by_metadata(tables["chunk"], {"repo": "repo0"}, limit=REPO_CHUNKS)

        # ---- the API pod (--redis --no-worker: no engine) boots while the
        # scope docs go in: host work only, so the card's free memory moves
        # only if the pod takes some
        api_port = _free_port()
        if cuda:
            torch.cuda.empty_cache()
            sync()
            free0 = torch.cuda.mem_get_info()[0]
        api = Pod("api", ["-m", "githubrepostorag_tpu_torch.api", "--redis", "--no-worker",
                          "--host", "127.0.0.1", "--port", str(api_port), *dev_flag],
                  {**os.environ, **cass_env, "DEVICE_INDEX": "off"})
        pods.append(api)
        n_docs = sum(len(d) for d in docs.values())
        t0 = time.monotonic()
        for scope, rows_ in docs.items():
            seed.upsert(tables[scope], rows_)
        upsert_s = time.monotonic() - t0
        counts = {scope: seed.count(tables[scope]) for scope in docs}
        want = {**{scope: len(d) for scope, d in docs.items()}, "chunk": 2 * REPO_CHUNKS}
        if written != {"chunk": REPO_CHUNKS} or counts != want:
            raise RuntimeError(f"the CQL stand-in holds {counts}, {want} were written")
        stats["cassandra_rows"] = counts
        stats["cassandra_seed_rows_per_s"] = n_docs / upsert_s
        stats["cassandra_seed_s"] = upsert_s
        stats["cassandra_chunk_write_rows_per_s"] = REPO_CHUNKS / chunk_s  # encode + upsert

        stats["api_pod_start_s"] = api.wait_for_line("service up", 120)
        status, health, _ = _http(api_port, "GET", "/health")
        if status != 200 or health["components"]["vectorStore"]["details"]["backend"] != "cassandra":
            raise RuntimeError(f"API pod /health: {status} {health}")
        if cuda:
            # another context on the card takes hundreds of MiB
            stats["api_pod_card_mib"] = (free0 - torch.cuda.mem_get_info()[0]) / 2 ** 20
            if stats["api_pod_card_mib"] > 128:
                raise RuntimeError(f"the API pod took {stats['api_pod_card_mib']:.0f} MiB of "
                                   "the card: it built an engine or a context")
        stats["api_pod_libcuda_mapped"] = _maps_libcuda(api.proc.pid)

        # ---- the device index, seeded from the stand-in
        t0 = time.monotonic()
        index = DeviceIndexedStore(cassandra(), k_bucket=s.device_index_k_bucket,
                                   max_wave=s.retrieval_max_wave, device=device)
        sync()
        stats["device_index_seed_s"] = time.monotonic() - t0
        dev_rows = {t: h["rows"] for t, h in index.health()["device_index"].items()}
        if dev_rows != {tables[scope]: n for scope, n in want.items()}:
            raise RuntimeError(f"the device index seeded {dev_rows}, the stand-in holds {want}")
        index.warmup()

        # ---- worker (a): this process, the rag phase's engine, Redis
        bus, flags, queue = CountingBus(url), RedisCancelFlags(url), RedisJobQueue(url)
        agent = GraphAgent(MeteredLLM(llm), RetrieverFactory(index, enc), namespace="default")
        worker = RagWorker(agent, bus, flags, queue)
        set_llm(llm)

        async def start():
            return asyncio.create_task(worker.run_forever())

        worker_a = (worker, run(start()), (bus, flags, queue))
        engine = llm.engine.engine
        # the rag phase's prompts sit in the engine's prefix cache (the
        # whole-repo prompt is the same one): take every free page, which
        # evicts the cached ones, and give them back uncached, so that the
        # jobs compare the buses and not a warm cache with a cold one
        alloc = engine._allocator
        alloc.release(alloc.allocate(alloc.free_count))
        hits0 = getattr(alloc, "hit_tokens", 0)
        free_pages = alloc.free_count
        reaps0 = engine.deadline_reaps
        searches0 = {p: counter_value(DEVICE_INDEX_SEARCHES, path=p) for p in ("device", "fallback")}
        jobs0 = {st: counter_value(JOBS_TOTAL, status=st) for st in ("ok", "cancelled", "timeout")}
        jobs = rag_jobs(short, code_repos=("repo0", "repo0"))  # repo0's code chunks
        reset_launches()
        t0 = time.monotonic()
        done = run_rag_jobs(api_port, jobs)
        traffic_s = time.monotonic() - t0
        deadline = time.monotonic() + 120
        while engine.has_work() and time.monotonic() < deadline:
            time.sleep(0.05)
        sync()
        launches = read_launches()

        states = [terminal_state(j) for j in done]
        if states != rag["terminal_states"]:
            raise RuntimeError(f"terminal states over Redis {states}, over the memory bus "
                               f"{rag['terminal_states']}")
        missed, walls, ttfts, turns = [], [], [], {}
        for job, state in zip(done, states):
            job_id, final = job["reply"]["job_id"], job["events"][-1]["data"]
            missed.append(stream_missed(bus.emitted[job_id], job["events"]))
            if state == "cancelled":
                flag = run(flags.is_cancelled(job_id))
                if job["result"].get("cancelled") is not True or not flag:
                    raise RuntimeError(f"cancelled job: result {job['result']}, the Redis "
                                       f"flag {'set' if flag else 'unset'}")
                continue
            if state == "deadline":
                if job["result"] != {"answer": "", "sources": [], "error": final["error"]}:
                    raise RuntimeError(f"deadline job: result {job['result']}")
                stats["deadline_job_first_llm_s"] = first_llm_start(
                    get_recorder().trace_payload(job["reply"]["trace_id"]))
                continue
            if job["result"].get("answer") != final["answer"] or not final["sources"]:
                raise RuntimeError(f"job {job['body']['query']!r}: result {job['result']} vs "
                                   f"final {final}")
            trace = get_recorder().trace_payload(job["reply"]["trace_id"])
            if trace is None:
                raise RuntimeError(f"job {job_id}: the worker recorded no trace")
            retrieval = [e for e in job["events"] if e["event"] == "retrieval"]
            turns[job["body"]["query"]] = [t["stage"] for t in retrieval[0]["data"]["turns"]] \
                if retrieval else None
            walls.append(job["wall_s"])
            ttfts.append(synthesis_ttft(trace)["ttft_s"])
            if "architecture" in job["body"]["query"]:
                stats["whole_repo_ttft_s"] = ttfts[-1]
        longctx = [q for q, t in turns.items() if t and "assemble" in t]
        if len(longctx) != 1 or "architecture" not in longctx[0]:
            raise RuntimeError(f"the whole-repo question's turns over Redis: {turns}")
        reaped = engine.deadline_reaps - reaps0
        searches = {p: counter_value(DEVICE_INDEX_SEARCHES, path=p) - searches0[p]
                    for p in searches0}
        jobs_total = {st: counter_value(JOBS_TOTAL, status=st) - jobs0[st] for st in jobs0}
        if reaped < 1 or jobs_total != {"ok": 6, "cancelled": 1, "timeout": 1}:
            # where the deadline job's budget went: its trace's spans by
            # start offset (no llm.generate: the budget ran out before the
            # agent's first call, which then never reached the engine)
            job = next(j for j in done if "deadline_ms" in j["body"])
            trace = get_recorder().trace_payload(job["reply"]["trace_id"]) or {"spans": []}
            spans = [(sp["name"], sp.get("start_s"),
                      sp.get("duration_s")) for sp in trace["spans"]]
            raise RuntimeError(f"deadline reaps {reaped}, rag_jobs_total moved by {jobs_total}; "
                               f"the deadline job's spans {spans}, events "
                               f"{[e['event'] for e in job['events']]}, wall {job['wall_s']}")
        if searches["device"] <= 0 or searches["fallback"] != 0:
            raise RuntimeError(f"index searches in the split phase: {searches}")
        a, b = "fused_window_attention", "paged_attention_decode_staged"
        if cuda:
            if launches[a] <= 0 or launches[b] <= 0:
                raise RuntimeError(f"the split path launched A {launches[a]}, B {launches[b]} times")
            off = {k: n for k, n in launches.items() if k.split("@")[0] not in (a, b) and n}
            if off:
                raise RuntimeError(f"the split path launched kernels it never reaches: {off}")
        if engine.has_work() or engine._allocator.free_count != free_pages:
            raise RuntimeError(f"pages leaked: {engine._allocator.free_count} free, "
                               f"{free_pages} before the jobs")
        stats.update({
            "jobs": len(done), "terminal_states": states, "traffic_wall_s": traffic_s,
            "job_wall_p50_s": percentile(walls, 0.5), "job_wall_p95_s": percentile(walls, 0.95),
            "synth_ttft_p50_s": percentile(ttfts, 0.5),
            "memory_bus_job_wall_p50_s": rag["job_wall_p50_s"],
            "memory_bus_job_wall_p95_s": rag["job_wall_p95_s"],
            "memory_bus_synth_ttft_p50_s": rag["synth_ttft_p50_s"],
            "memory_bus_whole_repo_ttft_s": rag["whole_repo_ttft_s"],
            "prefix_cache_hit_tokens": getattr(alloc, "hit_tokens", 0) - hits0,
            "stream_frames_missed": missed, "stream_frames_missed_total": sum(missed),
            "frames_emitted": sum(len(bus.emitted[j["reply"]["job_id"]]) for j in done),
            "deadline_reaps": reaped, "index_searches": searches, "jobs_total": jobs_total,
            "kernel_a_launches": launches[a], "kernel_b_launches": launches[b],
            "launches": launches,
        })

        async def stop_a(worker, task, parts):
            worker.stop()
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
            await close_events(*parts)

        run(stop_a(*worker_a))
        worker_a = None
        set_llm(None)

        # ---- worker (b): the worker pod's entry point over a checkpoint
        ckpt = Path(tempfile.mkdtemp(prefix="ckpt-", dir=kernels.BUILD_DIR))
        wcfg, wparams = worker_ckpt or load_phase_tree()
        write_checkpoint(ckpt, wparams, wcfg)
        write_byte_tokenizer(ckpt, wcfg.vocab_size)
        del wparams
        metrics_port = _free_port()
        wb = Pod("worker", ["-m", "githubrepostorag_tpu_torch.worker", "--host", "127.0.0.1",
                            *dev_flag],
                 {**os.environ, **cass_env, "DEVICE_INDEX": "on", "LLM_BACKEND": "inprocess",
                  "MODEL_WEIGHTS_PATH": str(ckpt), "METRICS_PORT": str(metrics_port)})
        pods.append(wb)
        stats["worker_pod_start_to_ready_s"] = wb.wait_for_line("worker ready", 300)
        with ThreadPoolExecutor(2) as pool:
            pod_jobs = list(pool.map(lambda q: rag_job(api_port, {"query": q}), (
                "what does the function parse_tree return in repo: repo0?",
                "tell me about repo: repo1")))
        if [terminal_state(j) for j in pod_jobs] != ["final", "final"]:
            raise RuntimeError(f"worker pod jobs: {[j['events'][-3:] for j in pod_jobs]}")
        stats["worker_pod_job_wall_s"] = [j["wall_s"] for j in pod_jobs]
        status, text, _ = _http(metrics_port, "GET", "/metrics")
        if status != 200 or 'rag_jobs_total{status="ok"} 2.0' not in text:
            raise RuntimeError(f"worker pod /metrics: {status} "
                               f"{[ln for ln in str(text).splitlines() if 'rag_jobs_total' in ln]}")
        rc, stats["worker_pod_stop_s"] = wb.terminate(SPLIT_POD_STOP_S)
        if rc != 0 or not any("RAG worker stopped" in ln for ln in wb.lines):
            raise RuntimeError(f"worker pod exit {rc} on SIGTERM:\n{wb.tail()}")
        rc, stats["api_pod_stop_s"] = api.terminate(SPLIT_POD_STOP_S)
        if rc != 0:
            raise RuntimeError(f"API pod exit {rc} on SIGTERM:\n{api.tail()}")
        servers.terminate(SPLIT_STOP_S + 10)
        stopped = [ln for ln in servers.lines if ln.startswith("redis stop")]
        if not stopped or "timed out" in stopped[0]:
            raise RuntimeError(f"MiniRedis.stop() waited over {SPLIT_STOP_S} s: a connection "
                               f"was left open ({stopped})")
        stats["redis_stop_s"] = float(stopped[0].split()[3])

        # ---- the native store over the same chunk rows
        stats["native"] = native_store_check(chunk_docs, enc, texts[:8], device)
    finally:
        if worker_a is not None:
            worker, task, _ = worker_a
            worker.stop()
            task.cancel()
        for session in sessions:
            session.close()
        for pod in pods:
            pod.kill()
        loop.call_soon_threadsafe(loop.stop)
        thread.join(30)
        loop.close()
        set_llm(None)
        if ckpt is not None:
            shutil.rmtree(ckpt, ignore_errors=True)
    stats["phase_s"] = time.monotonic() - t_phase
    log(f"split on {torch.cuda.get_device_name(0) if cuda else 'cpu'}: {json.dumps(stats)}")
    return stats


def rag_and_split(cfg, params, index, enc, passages: int = 8192) -> tuple[dict, dict]:
    """The rag phase over the memory bus, then the split phase over Redis,
    both on one engine (``rag_llm``)."""
    rag_settings()
    llm, warmup_s = rag_llm(cfg, params)
    try:
        rag = phase_rag(cfg, params, index=index, enc=enc, passages=passages, llm=llm)
        rag["engine_warmup_s"] = warmup_s
        return rag, phase_split(cfg, llm, rag, enc, passages=passages)
    finally:
        llm.close()


def load_phase_tree(layers: int = 2):
    """The load phase's tree: Qwen2-7B at full width cut to ``layers``,
    random bf16 weights from its seed, on the card.  Returns (cfg, params)."""
    import dataclasses

    import torch

    from githubrepostorag_tpu_torch.models.qwen2 import Qwen2Config, init_params

    cfg = dataclasses.replace(Qwen2Config.qwen2_7b(), num_layers=layers)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 9)
    return cfg, init_params(cfg, gen, device="cuda", dtype=torch.bfloat16)


def launch_counters() -> dict:
    """Every kernel wrapper, whose ``launches`` (and A's and B's per pool
    branch, D's per loader, E's per kernel: ``name@int8``,
    ``int4_matmul@tma``, ``w4a8_matmul@mma`` ...) the engine phases read."""
    from githubrepostorag_tpu_torch.ops.fused_decode import fused_window_attention
    from githubrepostorag_tpu_torch.ops.int4_matmul import int4_matmul, w4a8_matmul
    from githubrepostorag_tpu_torch.ops.packed_prefill import packed_prefill_attention_seg
    from githubrepostorag_tpu_torch.ops.paged_decode import (
        paged_attention_decode, paged_attention_decode_staged)

    return {"fused_window_attention": fused_window_attention,
            "paged_attention_decode_staged": paged_attention_decode_staged,
            "paged_attention_decode": paged_attention_decode,
            "packed_prefill_attention_seg": packed_prefill_attention_seg,
            "int4_matmul": int4_matmul, "w4a8_matmul": w4a8_matmul}


# per-branch counts beside a wrapper's total: A and B by pool, D by loader,
# E by kernel
BRANCH_COUNTS = ("launches_by_pool", "launches_by_loader", "launches_by_kernel",
                 "launches_by_window", "launches_by_head_dim")


def _branch_key(name: str, attr: str, kind) -> str:
    """``name@kind``; A's window counts read ``name@S<window>``."""
    return f"{name}@S{kind}" if attr == "launches_by_window" else f"{name}@{kind}"


def reset_launches() -> None:
    for fn in launch_counters().values():
        fn.launches = 0
        for attr in BRANCH_COUNTS:
            if hasattr(fn, attr):
                setattr(fn, attr, dict.fromkeys(getattr(fn, attr), 0))


def read_launches() -> dict:
    out = {}
    for name, fn in launch_counters().items():
        out[name] = fn.launches
        for attr in BRANCH_COUNTS:
            for kind, n in getattr(fn, attr, {}).items():
                out[_branch_key(name, attr, kind)] = n
    return out


def phase_engine(cfg, params, label: str, required: tuple[str, ...], absent: tuple[str, ...] = (),
                 profile: bool = True, tail: bool = False, probe=None, **engine_kw) -> dict:
    """Serve the traffic below through AsyncEngine(Engine(params,
    **engine_kw)); every kernel's launch count is set to 0 just before and
    read just after: each kernel (or ``kernel@branch``) in ``required``
    must have launched, each in ``absent`` must not have.  ``tail``: then
    one more greedy request, resuming 100 tokens past the cached prefix
    (the width ladder's narrowest window, 128, on its own), outside the
    traffic's numbers and launches (``tail_launches``).  ``probe``: its
    ``reset()`` runs with the launch counts' reset, its ``read()`` (under
    ``probe``) with their read, and ``after(engine, prompts, sp)`` (merged
    into the result) at the end, on the decode wave."""
    import torch

    from githubrepostorag_tpu_torch.serving import AsyncEngine, Engine, SamplingParams

    torch.cuda.reset_peak_memory_stats()
    engine = Engine(params, cfg, page_size=128, num_pages=256, max_num_seqs=8,
                    prefill_chunk=512, decode_burst=8, max_seq_len=11712, device="cuda",
                    **engine_kw)
    t0 = time.monotonic()
    engine.warmup()
    torch.cuda.synchronize()
    log(f"{label} engine warmup {time.monotonic() - t0:.1f} s")

    rng = np.random.default_rng(SEED + 2)
    prefix = rng.integers(0, cfg.vocab_size, 1024).tolist()
    wave1 = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (100, 700, 1500, 3000)]
    wave1.append(prefix + rng.integers(0, cfg.vocab_size, 200).tolist())
    second = prefix + rng.integers(0, cfg.vocab_size, 300).tolist()
    # decode wave: 8 rows prefill in one chunk together, then only decode
    decode_wave = [rng.integers(0, cfg.vocab_size, 256).tolist() for _ in range(8)]
    tail_prompt = prefix + rng.integers(0, cfg.vocab_size, 100).tolist()
    n_new, n_decode = 32, 64
    greedy = SamplingParams(temperature=0.0, max_tokens=n_new)
    sampled = SamplingParams(temperature=0.7, top_p=0.9, max_tokens=n_new)
    long_greedy = SamplingParams(temperature=0.0, max_tokens=n_decode)

    async def serve():
        aeng = AsyncEngine(engine)
        await aeng.start()
        try:
            t_start = time.monotonic()
            sps = [greedy, greedy, sampled, greedy, greedy]
            first = await asyncio.gather(*(aeng.generate(p, sp) for p, sp in zip(wave1, sps)))
            t_mid = time.monotonic()
            streamed = []
            async for ev in aeng.stream(second, greedy):
                if ev.type == "token":
                    streamed.append(ev.token_id)
                else:
                    last = ev.result
            decoded = await asyncio.gather(*(aeng.generate(p, long_greedy) for p in decode_wave))
            counted = (read_launches(), engine._allocator.hit_tokens - hits_before,
                       probe.read() if probe is not None else None)
            tail_res = await aeng.generate(tail_prompt, greedy) if tail else None
            return first, last, streamed, decoded, t_start, t_mid, counted, tail_res
        finally:
            await aeng.stop()

    reset_launches()
    hits_before = engine._allocator.hit_tokens
    packed_before = (engine.packed_prefill_tokens, engine.packed_prefill_padding)
    if probe is not None:
        probe.reset()
    first, last, streamed, decoded, t_start, t_mid, (launches, hit, probed), tail_res = \
        asyncio.run(serve())
    torch.cuda.synchronize()
    served = read_launches()  # the traffic's launches and the tail's

    tails = [tail_res] if tail else []
    for res, want in ([(r, n_new) for r in first + [last] + tails]
                      + [(r, n_decode) for r in decoded]):
        if res.finish_reason != "length" or len(res.output_tokens) != want:
            raise RuntimeError(f"{res.request_id}: {res.finish_reason} after "
                               f"{len(res.output_tokens)} tokens ({res.error})")
        if not all(0 <= tok < cfg.vocab_size for tok in res.output_tokens):
            raise RuntimeError(f"{res.request_id}: token outside the vocabulary")
    if streamed != last.output_tokens:
        raise RuntimeError("streamed tokens differ from the final result")
    if hit < 1024:
        raise RuntimeError(f"prefix cache hit {hit} tokens, expected >= 1024")
    for name in required:
        if served.get(name, 0) <= 0:
            raise RuntimeError(f"{name} never launched on the {label} path")
    for name in absent:
        if served.get(name, 0) != 0:
            raise RuntimeError(f"{name} launched {served[name]} times on the {label} path, "
                               "which never reaches it")
    if engine._allocator.free_count != engine._allocator.num_pages:
        raise RuntimeError("pages leaked after the engine drained")

    ttft = sorted(r.ttft_s for r in first)
    # decode rate once every row of the decode wave has its first token
    first_tok = max(r.timings["first_token_t"] for r in decoded)
    done = max(r.timings["done_t"] for r in decoded)
    decode_tokens = sum(len(r.output_tokens) - 1 for r in decoded)
    stats = {
        "wave_prompt_tokens": [len(p) for p in wave1],
        "ttft_s": [round(x, 4) for x in ttft],
        "ttft_p50_s": ttft[len(ttft) // 2],
        "ttft_p95_s": ttft[-(-95 * len(ttft) // 100) - 1],  # nearest rank
        "wave_wall_s": t_mid - t_start,
        "decode_rows": len(decoded),
        "decode_tok_s": decode_tokens / (done - first_tok),
        "tpot_ms_p50": 1e3 * sorted(r.decode_time_s / (len(r.output_tokens) - 1)
                                    for r in decoded)[len(decoded) // 2],
        "prefix_hit_tokens": hit,
        "second_ttft_s": last.ttft_s,
        "launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    if engine.prefill_token_budget is not None:
        stats["packed_prefill_tokens"] = engine.packed_prefill_tokens - packed_before[0]
        stats["packed_prefill_padding"] = engine.packed_prefill_padding - packed_before[1]
    log(f"{label} engine on {torch.cuda.get_device_name(0)}: {json.dumps(stats)}")
    # the greedy rows' tokens (the sampled row aside), for run-to-run identity
    stats["greedy_tokens"] = ([r.output_tokens for i, r in enumerate(first) if i != 2]
                              + [last.output_tokens] + [r.output_tokens for r in decoded]
                              + [r.output_tokens for r in tails])
    if tail:
        stats["tail_launches"] = {k: n - launches.get(k, 0) for k, n in served.items()}
    if profile:
        stats["profile"] = profile_decode(engine, decode_wave,
                                          SamplingParams(temperature=0.0, max_tokens=17))
    if probe is not None:
        stats["probe"] = probed
        stats.update(probe.after(engine, decode_wave, SamplingParams(temperature=0.0,
                                                                     max_tokens=17)))
    return stats


# kernel B's device kernel by name: the split-K kernel, or the earlier
# one-pass kernel when another checkout's port is profiled; kernel F's is
# the same template, which no engine run reaches
B_KERNEL_NAMES = ("split_kernel", "decode_staged_kernel")


# kernel E's device kernels by name: the prologue and the main kernels, or
# another checkout's earlier kernels
E_KERNEL_NAMES = ("w4a8_prologue", "w4a8_mma_kernel", "w4a8_dp4a_kernel", "w4a8_kernel",
                  "w4a8_general_kernel")


def check_options_run(base: dict, run: dict) -> dict:
    """The bf16 engine run with ``prefill_widths=3`` and ``prefill_priority``
    against the default bf16 run on the same traffic: every greedy row's
    tokens identical, and kernel A launched at windows 512, 256 and 128."""
    a = "fused_window_attention"
    if run["greedy_tokens"] != base["greedy_tokens"]:
        diff = [i for i, (x, y) in enumerate(zip(run["greedy_tokens"], base["greedy_tokens"]))
                if x != y]
        raise RuntimeError(f"greedy rows {diff} differ with prefill_widths=3 and "
                           "prefill_priority from the default run")
    windows = {k.split("@S")[1]: n + run["tail_launches"].get(k, 0)
               for k, n in run["launches"].items() if k.startswith(a + "@S")}
    windows = {w: n for w, n in windows.items() if n}
    if not all(windows.get(w, 0) > 0 for w in ("512", "256", "128")):
        raise RuntimeError(f"kernel A launches by window {windows}: 512, 256 and 128 must appear")
    out = {"greedy_rows_identical": len(run["greedy_tokens"]), "a_launches_by_window": windows,
           "a_launches": run["launches"][a], "a_launches_default": base["launches"][a],
           "ttft_p50_s": run["ttft_p50_s"], "ttft_p50_s_default": base["ttft_p50_s"],
           "tpot_ms_p50": run["tpot_ms_p50"], "tpot_ms_p50_default": base["tpot_ms_p50"]}
    log(f"engine options on the card: {json.dumps(out)}")
    return out


def kernel_of(key: str) -> str | None:
    """Kernel A or C of a profiler key: the tensor-core body (one template,
    PACKED false for A, true for C), or another checkout's earlier kernels."""
    if "fused_window_kernel" in key or ("prefill_kernel<" in key and "false>" in key):
        return "A"
    if "packed_prefill_kernel" in key or ("prefill_kernel<" in key and "true>" in key):
        return "C"
    return None


def profile_decode(engine, prompts, sp) -> dict:
    """Where a decode-heavy request batch's time goes: the device's idle
    share (one minus kernel time, from a torch.profiler trace of the card
    only, over the wall time of the same call run unprofiled) and the
    kernels that take most of it; kernel B's total and its wrapper's
    launches in the profiled call; decode TPOT and the prefill tokens each
    call ran (the prefix cache may serve the repeats).  Outside the timed
    engine numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from githubrepostorag_tpu_torch.ops.fused_decode import fused_window_attention
    from githubrepostorag_tpu_torch.ops.int4_matmul import w4a8_matmul
    from githubrepostorag_tpu_torch.ops.packed_prefill import packed_prefill_attention_seg
    from githubrepostorag_tpu_torch.ops.paged_decode import paged_attention_decode_staged

    prefill = []

    def run():
        before = engine.prefill_tokens
        res = engine.generate(prompts, sp)
        torch.cuda.synchronize()
        prefill.append(engine.prefill_tokens - before)
        return res

    run()  # same shapes, so the measured runs are warm
    t0 = time.monotonic()
    res = run()
    wall_ms = (time.monotonic() - t0) * 1e3
    launches0 = paged_attention_decode_staged.launches
    a_launches0 = fused_window_attention.launches
    a_windows0 = dict(fused_window_attention.launches_by_window)
    c_launches0 = packed_prefill_attention_seg.launches
    e_launches0 = w4a8_matmul.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run()
        prof_wall_ms = (time.monotonic() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if "CUDA" in str(e.device_type)]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    b_ms = sum(e.self_device_time_total for e in kernels
               if any(n in e.key for n in B_KERNEL_NAMES)) / 1e3
    stats = {
        "rows": len(prompts), "prompt_tokens": len(prompts[0]),
        "new_tokens": sp.max_tokens, "wall_ms": wall_ms, "profiled_wall_ms": prof_wall_ms,
        "busy_ms": busy_ms, "idle_pct": 100 * (1 - busy_ms / wall_ms),
        "kernel_b_ms": b_ms,
        "kernel_b_launches": paged_attention_decode_staged.launches - launches0,
        "kernel_a_ms": sum(e.self_device_time_total for e in kernels
                           if kernel_of(e.key) == "A") / 1e3,
        "kernel_a_launches": fused_window_attention.launches - a_launches0,
        "kernel_a_launches_by_window": {
            str(w): n - a_windows0.get(w, 0)
            for w, n in fused_window_attention.launches_by_window.items()
            if n - a_windows0.get(w, 0)},
        "kernel_c_ms": sum(e.self_device_time_total for e in kernels
                           if kernel_of(e.key) == "C") / 1e3,
        "kernel_c_launches": packed_prefill_attention_seg.launches - c_launches0,
        # kernel E: the prologue and the main kernel by name (another
        # checkout's earlier kernel E: its kernels alone, without the ~15
        # torch ops of its route)
        "kernel_e_prologue_ms": sum(e.self_device_time_total for e in kernels
                                    if "w4a8_prologue" in e.key) / 1e3,
        "kernel_e_ms": sum(e.self_device_time_total for e in kernels
                           if any(n in e.key for n in E_KERNEL_NAMES)) / 1e3,
        "kernel_e_launches": w4a8_matmul.launches - e_launches0,
        "tpot_ms_p50": 1e3 * sorted(r.decode_time_s / (len(r.output_tokens) - 1)
                                    for r in res)[len(res) // 2],
        "prefill_tokens_per_call": prefill,
    }
    log(f"profile: {len(prompts)} rows x {sp.max_tokens} tokens, wall {wall_ms:.1f} ms unprofiled "
        f"({prof_wall_ms:.1f} ms profiled), device busy {busy_ms:.1f} ms, idle "
        f"{stats['idle_pct']:.1f}% of the unprofiled wall; kernel B {b_ms:.2f} ms over "
        f"{stats['kernel_b_launches']} launches; kernel A {stats['kernel_a_ms']:.2f} ms over "
        f"{stats['kernel_a_launches']} launches; kernel C {stats['kernel_c_ms']:.2f} ms over "
        f"{stats['kernel_c_launches']} launches; kernel E {stats['kernel_e_ms']:.2f} ms (prologue "
        f"{stats['kernel_e_prologue_ms']:.2f}) over {stats['kernel_e_launches']} launches; TPOT p50 {stats['tpot_ms_p50']:.2f} ms; "
        f"prefill tokens per call {prefill}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d}x  {e.key[:90]}")
    return stats


def phase_longctx(cfg, params, label: str, **engine_kw) -> dict:
    """Long-context decode, the shape of a code-RAG request (retrieved
    chunks plus the question): 8 rows of distinct random 7936-token prompts,
    17 greedy new tokens, profiled as profile_decode does, on an engine of
    its own whose pool holds every row (8 x 63 pages + spare, about 4 GB of
    KV at 7B)."""
    import torch

    from githubrepostorag_tpu_torch.serving import Engine, SamplingParams

    engine = Engine(params, cfg, page_size=128, num_pages=8 * 63 + 16, max_num_seqs=8,
                    prefill_chunk=512, decode_burst=8, max_seq_len=8192, device="cuda",
                    **engine_kw)
    engine.warmup()
    rng = np.random.default_rng(SEED + 11)
    prompts = [rng.integers(0, cfg.vocab_size, 7936).tolist() for _ in range(8)]
    log(f"long-context decode, {label}:")
    stats = profile_decode(engine, prompts, SamplingParams(temperature=0.0, max_tokens=17))
    if engine._allocator.free_count != engine._allocator.num_pages:
        raise RuntimeError("pages leaked after the long-context run")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return stats


def phase_int4_engine(cfg, qparams, earlier_port: bool = False) -> dict:
    """The engine phase on the int4-weight tree: A, B, D and E must launch,
    every D launch through TMA and every E launch through the tensor-core
    kernel.  ``earlier_port`` (``--only int4`` in another checkout whose
    ``w4a8_matmul`` has no ``launches_by_kernel``) skips the last check,
    and says so."""
    from githubrepostorag_tpu_torch.ops.int4_matmul import w4a8_matmul

    a, b = "fused_window_attention", "paged_attention_decode_staged"
    run = phase_engine(cfg, qparams, "int4", (a, b, "int4_matmul", "w4a8_matmul"))
    n = run["launches"]
    if n["int4_matmul@tma"] != n["int4_matmul"]:
        raise RuntimeError(f"kernel D on the int4 path: {n['int4_matmul']} launches, "
                           f"{n['int4_matmul@tma']} through the TMA loader")
    log(f"int4 path: all {n['int4_matmul']} launches of kernel D took the TMA loader")
    if earlier_port and not hasattr(w4a8_matmul, "launches_by_kernel"):
        log("int4 path: this checkout's kernel E counts no launches by kernel; "
            "the tensor-core check is skipped")
    elif n["w4a8_matmul@mma"] != n["w4a8_matmul"]:
        raise RuntimeError(f"kernel E on the int4 path: {n['w4a8_matmul']} launches, "
                           f"{n['w4a8_matmul@mma']} through the tensor-core kernel")
    else:
        log(f"int4 path: all {n['w4a8_matmul']} launches of kernel E took the tensor-core kernel")
    return run


SOURCES = {
    "fused_window_attention": ("githubrepostorag_tpu_torch/csrc/fused_window_attention.cu",
                               "githubrepostorag_tpu/ops/fused_decode.py:232"),
    "paged_attention_decode_staged": ("githubrepostorag_tpu_torch/csrc/paged_decode_staged.cu",
                                      "githubrepostorag_tpu/ops/pallas_paged.py:395"),
    "packed_prefill_attention_seg": ("githubrepostorag_tpu_torch/csrc/packed_prefill.cu",
                                     "githubrepostorag_tpu/ops/packed_prefill.py:198"),
    "int4_matmul": ("githubrepostorag_tpu_torch/csrc/int4_matmul.cu",
                    "githubrepostorag_tpu/ops/pallas_int4.py:418"),
    "w4a8_matmul": ("githubrepostorag_tpu_torch/csrc/w4a8_matmul.cu",
                    "githubrepostorag_tpu/ops/pallas_int4.py:305"),
    "paged_attention_decode": ("githubrepostorag_tpu_torch/csrc/paged_decode.cu",
                               "githubrepostorag_tpu/ops/pallas_paged.py:150"),
}


def small_wave_ttft(cfg, params, reps: int = 16, device: str = "cuda") -> list[dict]:
    """What the width ladder and its row floor cost or save on small waves,
    where the floor binds: TTFT (``generate`` with one new token, its wall
    and the result's ``ttft_s``, medians of ``reps`` fresh prompt sets) of
    one and of two 100-token prompts (short queries) and of one and of two
    612-token prompts (a 512-token chunk, then a ragged 100-token one, as
    an extractor prompt's last chunk), on the engine phase's geometry
    without prefix caching (every repeat prefills its whole prompt).  Three
    variants, in the order 1, 3, 3 unfloored, 3 unfloored, 3, 1:
    prefill_widths 1, prefill_widths 3, and prefill_widths 3 with
    ``prefill_row_floor`` 0 (the floor's cost).  Each pass records whether
    its first tokens equal prefill_widths 1's, and on the card the device's
    busy time in one more call of each case (torch.profiler, kernels
    only): the floor's cost on the device, apart from the host's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from githubrepostorag_tpu_torch.serving import Engine, SamplingParams

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    rng = np.random.default_rng(SEED + 47)
    cases = {f"{n}x{plen}": [[rng.integers(0, cfg.vocab_size, plen).tolist() for _ in range(n)]
                             for _ in range(reps)]
             for n, plen in ((1, 100), (2, 100), (1, 612), (2, 612))}
    engines = {}
    for widths in (1, 3):
        engines[widths] = Engine(params, cfg, page_size=128, num_pages=256, max_num_seqs=8,
                                 prefill_chunk=512, decode_burst=8, max_seq_len=11712,
                                 prefix_caching=False, device=device, prefill_widths=widths)
        engines[widths].warmup()
    one = SamplingParams(temperature=0.0, max_tokens=1)
    first_tokens: dict = {}
    passes = []
    for variant in ("1", "3", "3 unfloored", "3 unfloored", "3", "1"):
        engine = engines[int(variant[0])]
        engine.prefill_row_floor = 0 if variant.endswith("unfloored") else engine.prefill_chunk
        row = {"prefill_widths": int(variant[0]), "row_floor": engine.prefill_row_floor}
        for case, sets in cases.items():
            engine.generate(sets[0], one)  # same shapes, so the timed calls are warm
            walls, ttfts, toks = [], [], []
            for prompts in sets:
                sync()
                t0 = time.monotonic()
                res = engine.generate(prompts, one)
                walls.append((time.monotonic() - t0) * 1e3)
                ttfts += [r.ttft_s * 1e3 for r in res]
                toks.append([r.output_tokens for r in res])
            first_tokens.setdefault(case, toks)
            row[case] = {"wall_ms_p50": sorted(walls)[len(walls) // 2],
                         "ttft_ms_p50": sorted(ttfts)[len(ttfts) // 2],
                         "first_tokens_equal_widths_1": toks == first_tokens[case]}
            if device == "cuda":
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    engine.generate(sets[0], one)
                    sync()
                row[case]["device_busy_ms"] = sum(
                    e.self_device_time_total for e in prof.key_averages()
                    if "CUDA" in str(e.device_type)) / 1e3
        passes.append(row)
        log(f"small waves, prefill_widths={variant}: {json.dumps(row)}")
    del engines
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return passes


def phase_options(cfg, params, index, enc) -> dict:
    """``--only options``: the two engine options measured in pairs in one
    call, off / on / on / off (engine numbers spread up to 2x between
    calls): the long-context bf16 profile with prefill_widths 1 and 3 (A's
    total and launches by window), small waves' TTFT with prefill_widths 1
    and 3 and without the row floor (``small_wave_ttft``), and the rag
    phase's eight jobs with PREFILL_PRIORITY off and on (job wall,
    synthesis TTFT, the whole-repo job's TTFT)."""
    import torch

    out: dict = {"longctx_prefill_widths": [], "rag_prefill_priority": []}
    out["small_wave_ttft"] = small_wave_ttft(cfg, params)
    for widths in (1, 3, 3, 1):
        st = phase_longctx(cfg, params, f"bf16, prefill_widths={widths}", prefill_widths=widths)
        out["longctx_prefill_widths"].append({"prefill_widths": widths, **{
            k: st[k] for k in ("kernel_a_ms", "kernel_a_launches", "kernel_a_launches_by_window",
                               "kernel_b_ms", "busy_ms", "wall_ms", "idle_pct", "tpot_ms_p50",
                               "prefill_tokens_per_call")}})
    for priority in (False, True, True, False):
        st = phase_rag(cfg, params, index=index, enc=enc, prefill_priority=priority)
        out["rag_prefill_priority"].append({k: st[k] for k in (
            "prefill_priority", "job_wall_p50_s", "job_wall_p95_s", "synth_ttft_p50_s",
            "whole_repo_ttft_s", "traffic_wall_s", "kernel_a_launches", "kernel_b_launches")})
        gc.collect()
        torch.cuda.empty_cache()
    log(f"options: {json.dumps(out)}")
    return out


# ------------------------------------------------------------------ modes --

# the engine modes of the modes phase, as the model server's settings
MODE_RUNS = (
    ("default", {}),
    ("spec", {"SPEC_NGRAM_K": "4"}),
    ("burst", {"SPEC_NGRAM_K": "4", "SPEC_BURST_ITERS": "4"}),
    ("fused", {"SPEC_NGRAM_K": "4", "SPEC_BURST_ITERS": "4", "FUSED_STEP": "1",
               "PREFILL_TOKEN_BUDGET": "2048"}),
)
MODE_KEYS = ("SPEC_NGRAM_K", "SPEC_BURST_ITERS", "FUSED_STEP", "PREFILL_TOKEN_BUDGET",
             "PREFILL_PRIORITY", "PREFILL_WIDTHS", "KV_QUANT", "KV_TIER",
             "KV_HOST_POOL_PAGES", "PREEMPT", "SPEC_DRAFT_MODEL", "SPEC_K", "SPEC_ITERS",
             "SPEC_ACCEPT_FLOOR", *ENGINE_GEOMETRY)


def mode_settings(env: dict | None = None):
    """The engine phase's geometry and ``env`` in the environment, every
    other mode setting unset (its default), settings reloaded: what
    ``python -m githubrepostorag_tpu_torch.serving`` reads."""
    import os

    from githubrepostorag_tpu_torch import config

    for key in MODE_KEYS:
        os.environ.pop(key, None)
    os.environ.update(ENGINE_GEOMETRY)
    os.environ.update(env or {})
    return config.reload_settings()


def mode_engine(cfg, params, env: dict, device: str = "cuda"):
    """The model server's engine for ``env`` (``serving/__main__.build_engine``
    over the settings), warmed up."""
    from githubrepostorag_tpu_torch.serving.__main__ import build_engine

    engine = build_engine(mode_settings(env), params, cfg, device)
    engine.warmup()
    return engine


def quoting_prompts(rng, vocab: int, lens: list[int], span: int = 128) -> list[list[int]]:
    """RAG-shaped prompts (``tests/test_spec_decode.py::
    test_rag_quoting_construction``'s idea): shuffled retrieved chunks of
    ``span`` random tokens, then the first 8 tokens of one of them, where
    an answer quoting that chunk begins, so the n-gram drafter finds the
    rest of the span."""
    out = []
    for n in lens:
        chunks = [rng.integers(0, vocab, span).tolist() for _ in range(max(1, n // span))]
        body = [t for c in chunks for t in c][: n - 8]
        out.append(body + chunks[int(rng.integers(len(chunks)))][:8])
    return out


def modes_traffic(cfg) -> dict:
    """The modes phase's traffic: a 5-request wave of quoting prompts (512
    to 2048 tokens, 32 greedy tokens each) and a decode wave of 8 x 64
    greedy tokens over 256-token quoting prompts."""
    rng = np.random.default_rng(SEED + 53)
    return {"wave": quoting_prompts(rng, cfg.vocab_size, [512, 900, 1300, 2048, 700]),
            "decode": quoting_prompts(rng, cfg.vocab_size, [256] * 8), "n_new": 32,
            "n_decode": 64}


def serve_modes_traffic(engine, traffic: dict, sampled: tuple[int, ...] = ()) -> dict:
    """Serve ``traffic`` through AsyncEngine(engine), every launch count set
    to 0 just before and read just after: the wave at once (rows in
    ``sampled`` at temperature 0.8, top-p 0.9), then the decode wave at
    once.  Returns the results, launches, and the engine's dispatch and
    speculation counters over the decode wave; the compile watchdog's
    count (``rag_xla_compiles_total``: first-time kernel work after the
    driver's start, which must stay 0) and the obs hooks' host us a step
    beside the step's."""
    import torch

    from githubrepostorag_tpu_torch import metrics
    from githubrepostorag_tpu_torch.serving import AsyncEngine, SamplingParams

    greedy = SamplingParams(temperature=0.0, max_tokens=traffic["n_new"])
    sampled_sp = SamplingParams(temperature=0.8, top_p=0.9, max_tokens=traffic["n_new"])
    long_greedy = SamplingParams(temperature=0.0, max_tokens=traffic["n_decode"])
    sps = [sampled_sp if i in sampled else greedy for i in range(len(traffic["wave"]))]

    def counters():
        return (engine.step_dispatches_total, engine.spec_proposed, engine.spec_accepted,
                engine.fused_steps_total)

    obs = {}

    async def serve():
        aeng = AsyncEngine(engine)
        await aeng.start()
        compiles0 = metrics.counter_value(metrics.XLA_COMPILES, replica=aeng.replica)
        try:
            t0 = time.monotonic()
            first = await asyncio.gather(*(aeng.generate(p, sp)
                                           for p, sp in zip(traffic["wave"], sps)))
            t1 = time.monotonic()
            c0 = counters()
            decoded = await asyncio.gather(*(aeng.generate(p, long_greedy)
                                             for p in traffic["decode"]))
            return first, decoded, t1 - t0, c0, counters()
        finally:
            await aeng.stop()
            steps = max(1, aeng.steps_total)
            obs.update(watchdog_compiles=metrics.counter_value(
                metrics.XLA_COMPILES, replica=aeng.replica) - compiles0,
                obs_us_per_step=1e6 * aeng.obs_seconds_total / steps,
                step_us_mean=1e6 * aeng.step_seconds_total / steps, driver_steps=aeng.steps_total)

    reset_launches()
    c_start = counters()
    first, decoded, wave_s, c0, c1 = asyncio.run(serve())
    torch.cuda.synchronize()
    launches = read_launches()
    for res in first + decoded:
        want = traffic["n_decode"] if res in decoded else traffic["n_new"]
        if res.finish_reason != "length" or len(res.output_tokens) != want:
            raise RuntimeError(f"{res.request_id}: {res.finish_reason} after "
                               f"{len(res.output_tokens)} tokens ({res.error})")
        if not all(0 <= t < engine.cfg.vocab_size for t in res.output_tokens):
            raise RuntimeError(f"{res.request_id}: token outside the vocabulary")
    if engine._allocator.free_count != engine._allocator.num_pages:
        raise RuntimeError("pages leaked after the modes traffic")
    first_tok = max(r.timings["first_token_t"] for r in decoded)
    done = max(r.timings["done_t"] for r in decoded)
    decode_tokens = sum(len(r.output_tokens) - 1 for r in decoded)
    dispatches = c1[0] - c0[0]
    return {
        "results": first + decoded, "greedy_rows": [i for i in range(len(first + decoded))
                                                    if i not in sampled],
        "launches": launches, "wave_wall_s": wave_s,
        "ttft_p50_s": sorted(r.ttft_s for r in first)[len(first) // 2],
        "decode_tok_s": decode_tokens / (done - first_tok),
        "tpot_ms_p50": 1e3 * sorted(r.decode_time_s / (len(r.output_tokens) - 1)
                                    for r in decoded)[len(decoded) // 2],
        "decode_dispatches": dispatches,
        "tokens_per_dispatch": sum(len(r.output_tokens) for r in decoded) / max(1, dispatches),
        "spec_proposed": c1[1] - c_start[1], "spec_accepted": c1[2] - c_start[2],
        "decode_proposed": c1[1] - c0[1], "decode_accepted": c1[2] - c0[2],
        "fused_steps": c1[3] - c_start[3],
        "a_launches_per_token": 0.0,  # filled below
        **obs,
    }


def pin_mode_launches(label: str, n: dict, required: tuple[str, ...],
                      absent: tuple[str, ...]) -> None:
    for name in required:
        if n.get(name, 0) <= 0:
            raise RuntimeError(f"{name} never launched on the {label} path")
    for name in absent:
        if n.get(name, 0) != 0:
            raise RuntimeError(f"{name} launched {n[name]} times on the {label} path, "
                               "which never reaches it")


def teacher_logits(params, cfg, rows: list[tuple[list[int], list[int]]], widths: tuple[int, ...],
                   n_rows: int = 8, device: str = "cuda") -> list:
    """Teacher-forced logits of each row's output positions, one float32
    tensor [len(rows), n_out, V] for each window width in ``widths``: every
    row's prompt prefilled (512-token chunks, one row at a time), then the
    rows' given outputs fed together, ``width`` tokens a row a forward,
    padded to ``n_rows`` rows: the GEMM shape of the path compared (8 rows
    x 1 token is the decode burst's, 8 x 5 a verify window's).  Every width
    starts from the same prefix K/V and rewrites the output positions'."""
    import torch

    from githubrepostorag_tpu_torch.models.qwen2 import forward_paged
    from githubrepostorag_tpu_torch.serving.kv_cache import make_page_pools

    ps, dev = 128, torch.device(device)
    n_out = len(rows[0][1])
    per_row = max(-(-(len(p) + len(o)) // ps) for p, o in rows)
    pools = make_page_pools(cfg, per_row * n_rows, ps, dtype=params["norm"].dtype, device=dev)
    bt = torch.arange(per_row * n_rows, dtype=torch.int32, device=dev).reshape(n_rows, per_row)

    def run(row_ids, starts, lens_new, w, logits_at=None):
        r = len(row_ids)
        ids = torch.zeros((r, w), dtype=torch.int32)
        pos = torch.zeros((r, w), dtype=torch.int32)
        for i, (toks, s0) in enumerate(zip(row_ids, starts)):
            ids[i, : len(toks)] = torch.tensor(toks, dtype=torch.int32)
            pos[i] = s0 + torch.arange(w, dtype=torch.int32)
        valid = torch.arange(w)[None, :] < torch.tensor(lens_new)[:, None]
        tbl = bt[: r].cpu()
        slots = torch.where(valid, tbl.gather(1, (pos // ps).clamp(max=per_row - 1)) * ps + pos % ps,
                            -1)
        t = [x.to(dev) for x in (ids, pos, slots)]
        return forward_paged(params, cfg, t[0], t[1], pools.k, pools.v, t[2], bt[: r],
                             torch.tensor(starts, dtype=torch.int32, device=dev),
                             torch.tensor(lens_new, dtype=torch.int32, device=dev),
                             logits_at=logits_at)[0]

    seqs = [p + o for p, o in rows]
    starts = [len(p) - 1 for p, _ in rows]
    for i, (p, _) in enumerate(rows):  # each prompt but its last token
        for c in range(0, starts[i], 512):
            n = min(512, starts[i] - c)
            toks = [[]] * i + [p[c: c + n]]
            run(toks, [0] * i + [c], [0] * i + [n], 512,
                torch.tensor([0] * i + [n - 1], dtype=torch.int32, device=dev))
    pad = n_rows - len(rows)
    out = []
    for w in widths:
        chunks = []
        for t in range(0, n_out, w):
            n = min(w, n_out - t)
            logits = run([seq[s0 + t: s0 + t + n] for seq, s0 in zip(seqs, starts)] + [[]] * pad,
                         [s0 + t for s0 in starts] + [0] * pad, [n] * len(rows) + [0] * pad, w)
            chunks.append(logits[: len(rows), :n].float())
        out.append(torch.cat(chunks, dim=1))
    del pools
    return out


def check_bf16_divergence(params, cfg, groups: list[list[int]], prompts: list[list[int]],
                          plain: list[list[int]], runs: dict, device: str = "cuda",
                          widths: tuple[int, ...] = (5,)) -> dict:
    """Greedy rows of each bf16 spec run against the default run's.  Where
    a row's tokens first differ, at position p, the divergence must be a
    near tie.  The default run's outputs are teacher-forced per group of
    rows that decoded together (``groups``: the wave, the decode wave),
    once through 8 x 1-token windows (the decode burst's GEMM rows) and
    once through 8 x 5-token windows (a verify window's); D is the largest
    gap between the two logits of any output position of the row up to
    p.  If each path's logits lie within D of the other's, two different
    argmaxes are at most 2 D apart: the teacher-forced logits of the two
    tokens at p must be within 2 D.  ``widths``: the windows D is taken
    over (the draft's verify rungs add 2 and 3)."""
    import torch

    out = {"rows_compared": 0, "divergent": [], "largest_bound": None}
    forced: dict = {}
    for name, rows in runs.items():
        for i, other in rows.items():
            out["rows_compared"] += 1
            ref = plain[i]
            p = next((j for j, (x, y) in enumerate(zip(ref, other)) if x != y), None)
            if p is None:
                continue
            group = next(g for g in groups if i in g)
            if group[0] not in forced:
                l1, *lw = teacher_logits(params, cfg, [(prompts[j], plain[j]) for j in group],
                                         (1, *widths), device=device)
                gaps = torch.stack([(l1 - x).abs().amax(dim=-1) for x in lw]).amax(dim=0)
                forced[group[0]] = (l1, gaps, lw[-1].argmax(dim=-1))
                del lw
                if device == "cuda":
                    torch.cuda.empty_cache()
            l1, d, arg5 = forced[group[0]]
            k = group.index(i)
            bound = 2 * float(d[k, : p + 1].max())
            a, b = ref[p], other[p]
            gap = float((l1[k, p, a] - l1[k, p, b]).abs())
            top2 = torch.topk(l1[k, p], 2).values
            entry = {"run": name, "row": i, "position": p, "tokens": [a, b],
                     "logit_gap": gap, "bound_2D": bound,
                     "top1_top2_margin": float(top2[0] - top2[1]),
                     "forced_s1_argmax": int(l1[k, p].argmax()), "forced_s5_argmax": int(arg5[k, p])}
            out["divergent"].append(entry)
            if gap > bound:
                raise RuntimeError(f"bf16 {name} row {i} diverges from the default run at "
                                   f"token {p} where the logit gap {gap:.4f} exceeds the "
                                   f"bound 2D = {bound:.4f}: not a near tie ({entry})")
    if out["divergent"]:
        out["largest_bound"] = max(e["bound_2D"] for e in out["divergent"])
        out["largest_gap"] = max(e["logit_gap"] for e in out["divergent"])
    return out


def narrator_params(params: dict) -> dict:
    """The JAX package's quoting construction at Qwen2-7B's shapes
    (``tests/test_spec_decode.py::test_rag_quoting_construction``): every
    layer's weights zero (norms one) and an untied lm_head whose column o
    is the embedding's row o - 1, so greedy decoding narrates t -> t + 1
    through all 28 layers, with wide margins; the same kernels and GEMM
    shapes run as with random weights."""
    import torch

    layers = {k: (v if k in ("ln1", "ln2") else torch.zeros_like(v))
              for k, v in params["layers"].items()}
    return {**params, "layers": layers,
            "lm_head": torch.roll(params["embed"], 1, dims=0).t().contiguous()}


def narrator_traffic(cfg) -> dict:
    """Prompts of shuffled consecutive-token chunks ending with one chunk's
    first token: the narrator continues that chunk, the bigram drafter
    finds it in the prompt, and drafts are accepted up to the chunk's end
    (partial acceptance).  5 x 32 tokens, then 8 x 64."""
    rng = np.random.default_rng(SEED + 67)

    def prompt(span: int, n_chunks: int) -> list[int]:
        s0 = int(rng.integers(0, cfg.vocab_size - span * n_chunks))
        chunks = [list(range(s0 + span * j, s0 + span * (j + 1))) for j in range(n_chunks)]
        return [t for j in rng.permutation(n_chunks) for t in chunks[j]] + [s0]

    return {"wave": [prompt(48, 8) for _ in range(5)], "decode": [prompt(64, 4) for _ in range(8)],
            "n_new": 32, "n_decode": 64}


def sync_free_bursts(engine, traffic: dict) -> dict:
    """One spec burst and one fused step (with a packed prefill phase) on
    the engine's rows with ``torch.cuda.set_sync_debug_mode("error")``:
    any host sync inside raises.  The inputs are made before; the rows are
    cancelled after (the bursts' KV writes past the rows' lengths are
    overwritten by later tokens)."""
    import torch

    from githubrepostorag_tpu_torch.serving import SamplingParams
    from githubrepostorag_tpu_torch.serving.fused_step import fused_step_burst
    from githubrepostorag_tpu_torch.serving.spec_burst import spec_decode_burst

    rids = [engine.add_request(p, SamplingParams(temperature=0.0, max_tokens=64))
            for p in traffic["decode"]]
    while any(r.state == "waiting" or r.state == "prefilling"
              for r in engine._requests.values()):
        engine.step()
    running = [r for r in engine._row_req.values() if r.state == "running"]
    w = engine._spec_window_rows(running)
    t = engine._tensor
    args = [t(w[k]) for k in ("hist", "hlens", "lens")]
    rest = [t(w[k]) for k in ("bt", "limits", "active")]
    engine._push_sampling()
    rows = t(w["row_idx"])
    rl = rows.long()
    samp = [engine._temp_d[rl], engine._top_p_d[rl], engine._top_k_d[rl], engine._rep_pen_d[rl]]
    budget = 2048
    pf = (torch.zeros((1, budget), dtype=torch.int32, device="cuda"),
          torch.zeros((1, budget), dtype=torch.int32, device="cuda"),
          torch.full((budget,), -1, dtype=torch.int32, device="cuda"),
          torch.zeros((8, engine.max_pages_per_seq), dtype=torch.int32, device="cuda"),
          torch.zeros((8,), dtype=torch.int32, device="cuda"),
          torch.zeros((8,), dtype=torch.int32, device="cuda"),
          torch.full((budget,), 8, dtype=torch.int32, device="cuda"),
          torch.zeros((8,), dtype=torch.int32, device="cuda"))
    spec_ok = t(w["spec_ok"])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        toks, prop, *_ = spec_decode_burst(engine.params, engine.cfg, *args, engine._k_pages,
                                           engine._v_pages, *rest, n_iters=4, k=4)
        ftoks, fprop, *_ = fused_step_burst(
            engine.params, engine.cfg, *args, engine._k_pages, engine._v_pages, *rest, spec_ok,
            rows, engine._presence, engine._gen, *samp, *pf, n_iters=4, k=4, tq=512,
            filter_sampling=True, has_prefill=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    block = torch.cat([toks.flatten(), ftoks.flatten()]).cpu()
    for rid in rids:
        engine.cancel(rid)
    while engine.has_work():
        engine.step()
    if not ((block >= -1) & (block < engine.cfg.vocab_size)).all():
        raise RuntimeError("a burst under sync-debug mode returned tokens outside the vocabulary")
    return {"rows": len(running), "spec_burst_tokens": int((toks >= 0).sum()),
            "fused_tokens": int((ftoks >= 0).sum()), "host_syncs": 0}


def f32_identity(cfg, params) -> dict:
    """Exact identity in float32: Qwen2-7B at full width cut to 2 layers,
    float32 weights and pages (kernel A's f32 route), TF32 off; default,
    spec, burst and fused engines on the modes traffic, every greedy token
    equal to the default engine's."""
    import dataclasses

    import torch

    from githubrepostorag_tpu_torch.serving import Engine, SamplingParams

    cfg2 = dataclasses.replace(cfg, num_layers=2)
    p2 = upcast({**params, "layers": {k: v[:2] for k, v in params["layers"].items()}})
    traffic = modes_traffic(cfg)
    kw = dict(page_size=128, num_pages=256, max_num_seqs=8, prefill_chunk=512, decode_burst=8,
              max_seq_len=11712, kv_dtype=torch.float32, device="cuda")
    env_kw = {"default": {}, "spec": {"spec_ngram_k": 4},
              "burst": {"spec_ngram_k": 4, "spec_burst_iters": 4},
              "fused": {"spec_ngram_k": 4, "spec_burst_iters": 4, "fused_step": True,
                        "prefill_token_budget": 2048}}
    tokens, launches = {}, {}
    for name, mode in env_kw.items():
        engine = Engine(p2, cfg2, **kw, **mode)
        reset_launches()
        res = engine.generate(traffic["wave"] + traffic["decode"],
                              SamplingParams(temperature=0.0, max_tokens=traffic["n_new"]))
        torch.cuda.synchronize()
        launches[name] = read_launches()
        tokens[name] = [r.output_tokens for r in res]
        del engine
    for name in ("spec", "burst", "fused"):
        diff = [i for i, (x, y) in enumerate(zip(tokens[name], tokens["default"])) if x != y]
        if diff:
            raise RuntimeError(f"float32 {name} rows {diff} differ from the default engine's")
        pin_mode_launches(f"f32 {name}", launches[name], ("fused_window_attention",
                                                          "fused_window_attention@S5"),
                          ("paged_attention_decode_staged",))
    out = {"rows_identical": len(tokens["default"]),
           "tokens_each": sum(len(t) for t in tokens["default"])}
    log(f"modes, float32 (2 layers): {json.dumps(out)}")
    del p2
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tier_run(cfg, params) -> dict:
    """The host KV tier at 7B: a 48-page device pool (350 MB of bf16 KV)
    behind a 256-page host pool; four distinct 2048-token prefixes served
    one after another (the later ones reclaim the first's pages after
    their writeback), then the first again: it must fault in, give its
    first serve's tokens, and its faulted pages must hold its written-back
    bytes exactly.  Then the engine's own migration calls timed on 15
    pages each way (device time with a sync, GB/s) beside a plain pinned
    copy of the same bytes in the same run."""
    import torch

    from githubrepostorag_tpu_torch.ops.page_migration import gather_pages, scatter_pages
    from githubrepostorag_tpu_torch.serving import SamplingParams
    from githubrepostorag_tpu_torch.serving.kv_cache import page_hashes

    engine = mode_engine(cfg, params, {"KV_TIER": "on", "KV_HOST_POOL_PAGES": "256",
                                       "KV_NUM_PAGES": "48"})
    rng = np.random.default_rng(SEED + 59)
    prefixes = [rng.integers(0, cfg.vocab_size, 2048).tolist() for _ in range(4)]
    sp = SamplingParams(temperature=0.0, max_tokens=32)
    al = engine._allocator
    # the first prefix's shareable pages: every full page but the last token's
    hashes = page_hashes(prefixes[0], 128)[: (len(prefixes[0]) - 1) // 128]
    first = engine.generate([prefixes[0]], sp)[0]
    engine.flush_kv_migrations()
    pages = [al._hash_to_page[h] for h in hashes]
    idx = torch.tensor(pages, dtype=torch.int32, device="cuda")
    before = [x.cpu() for x in gather_pages(engine._k_pages, engine._v_pages, idx)[:2]]
    t0 = time.monotonic()
    for p in prefixes[1:]:
        engine.generate([p], sp)
        engine.flush_kv_migrations()
    if any(h in al._hash_to_page for h in hashes):
        raise RuntimeError("the first prefix kept device pages after three others")
    again = engine.generate([prefixes[0]], sp)[0]
    torch.cuda.synchronize()
    traffic_s = time.monotonic() - t0
    if again.faulted_pages <= 0:
        raise RuntimeError("the evicted prefix did not fault in")
    if again.output_tokens != first.output_tokens:
        raise RuntimeError("the faulted-in prefix's tokens differ from its first serve's")
    pages2 = [al._hash_to_page[h] for h in hashes]
    after = [x.cpu() for x in gather_pages(engine._k_pages, engine._v_pages,
                                           torch.tensor(pages2, dtype=torch.int32,
                                                        device="cuda"))[:2]]
    if not all(torch.equal(a, b) for a, b in zip(before, after)):
        raise RuntimeError("round-tripped KV pages are not byte-equal")
    if al.free_count != al.num_pages:
        raise RuntimeError("pages leaked after the tier run")

    # the migration calls alone, 15 pages each way, and a plain pinned copy
    n = len(hashes)
    idx = torch.tensor(pages2, dtype=torch.int32, device="cuda")  # written back as read
    page_bytes = 2 * engine._k_pages[:, :, 0].numel() * engine._k_pages.element_size()
    times = {"writeback": [], "fault_in": [], "pinned_d2h": [], "pinned_h2d": []}
    flat = torch.empty(n * page_bytes // 2, dtype=torch.bfloat16, device="cuda")
    host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
    vals = None
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        bufs = gather_pages(engine._k_pages, engine._v_pages, idx)
        hb, ev = engine._to_host(bufs)
        ev.synchronize()
        times["writeback"].append(time.perf_counter() - t)
        vals = hb
        t = time.perf_counter()
        dev = [x.to("cuda", non_blocking=True) for x in vals[:2]]
        scatter_pages(engine._k_pages, engine._v_pages, idx, dev[0], v_vals=dev[1])
        torch.cuda.synchronize()
        times["fault_in"].append(time.perf_counter() - t)
        t = time.perf_counter()
        host.copy_(flat, non_blocking=True)
        torch.cuda.synchronize()
        times["pinned_d2h"].append(time.perf_counter() - t)
        t = time.perf_counter()
        flat.copy_(host, non_blocking=True)
        torch.cuda.synchronize()
        times["pinned_h2d"].append(time.perf_counter() - t)
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    out = {
        "device_pages": al.num_pages, "host_pool_pages": al.host_pool_pages,
        "prefix_pages": n, "faulted_pages": again.faulted_pages,
        "writebacks": al.writebacks, "tier_drops": al.tier_drops, "fault_ins": al.fault_ins,
        "kv_migrations": engine.kv_migrations, "kv_fault_dispatches": engine.kv_fault_dispatches,
        "migration_host_s": engine.migration_seconds_total,
        "fault_in_host_s": engine.fault_in_seconds_total, "traffic_s": traffic_s,
        "tokens_equal_first_serve": True, "pages_byte_equal": n,
        "page_mb": page_bytes / 2 ** 20,
        **{f"{k}_ms_per_page": 1e3 * v / n for k, v in med.items()},
        **{f"{k}_gb_s": n * page_bytes / v / 1e9 for k, v in med.items()},
    }
    log(f"modes, host tier: {json.dumps(out)}")
    del engine, vals, host, flat
    gc.collect()
    torch.cuda.empty_cache()
    return out


def preempt_run(cfg, params) -> dict:
    """Preempt-to-host at 7B: two rows (MAX_NUM_SEQS=2) over a 20-page
    device pool; two batch requests (1024-token prompts, 96 tokens) fill
    it, then an interactive one (512 tokens, 16) arrives.  With PREEMPT=on
    exactly one batch row parks and resumes with no prompt token
    recomputed and no page leaked; its TTFT beside the same traffic with
    PREEMPT=off, where it waits for a row."""
    import torch

    from githubrepostorag_tpu_torch.serving import SamplingParams

    rng = np.random.default_rng(SEED + 61)
    batch = [rng.integers(0, cfg.vocab_size, 1024).tolist() for _ in range(2)]
    hot = rng.integers(0, cfg.vocab_size, 512).tolist()
    out = {}
    for preempt in ("off", "on"):
        engine = mode_engine(cfg, params, {"KV_TIER": "on", "KV_HOST_POOL_PAGES": "256",
                                           "KV_NUM_PAGES": "20", "MAX_NUM_SEQS": "2",
                                           "PREEMPT": preempt})
        results = []
        rids = [engine.add_request(p, SamplingParams(temperature=0.0, max_tokens=96),
                                   priority="batch") for p in batch]
        while engine.num_running < 2 or any(r.state != "running"
                                            for r in engine._row_req.values()):
            results += engine.step()
        results += engine.step()
        hot_id = engine.add_request(hot, SamplingParams(temperature=0.0, max_tokens=16))
        steps = 0
        while engine.has_work():
            results += engine.step()
            steps += 1
            if steps > 2000:
                raise RuntimeError("preempt run wedged")
        engine.flush_kv_migrations()
        torch.cuda.synchronize()
        by_id = {r.request_id: r for r in results}
        if any(by_id[r].finish_reason != "length" for r in rids + [hot_id]):
            raise RuntimeError(f"preempt={preempt}: a request did not finish by length")
        if engine._allocator.free_count != engine._allocator.num_pages:
            raise RuntimeError(f"preempt={preempt}: pages leaked")
        out[preempt] = {
            "hot_ttft_s": by_id[hot_id].ttft_s,
            "batch_tokens": [by_id[r].output_tokens for r in rids],
            "preemptions": engine.preemptions, "preempt_resumes": engine.preempt_resumes,
            "preempted_pages": engine.preempted_pages,
            "resume_faulted_pages": engine.resume_faulted_pages,
            "resume_recomputed_tokens": engine.resume_recomputed_tokens,
            "resume_recomputed_prompt_tokens": engine.resume_recomputed_prompt_tokens,
            "parked": [by_id[r].preempted for r in rids],
        }
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    on = out["on"]
    if on["preemptions"] != 1 or on["preempt_resumes"] != 1:
        raise RuntimeError(f"preempt run: {on['preemptions']} parks, {on['preempt_resumes']} "
                           "resumes; expected one of each")
    if on["resume_recomputed_prompt_tokens"] != 0:
        raise RuntimeError("the resumed victim recomputed prompt tokens")
    if out["off"]["preemptions"] != 0:
        raise RuntimeError("PREEMPT=off parked a request")
    res = {"hot_ttft_s_preempt_off": out["off"]["hot_ttft_s"],
           "hot_ttft_s_preempt_on": on["hot_ttft_s"],
           "batch_rows_equal_unpreempted": sum(a == b for a, b in zip(
               on["batch_tokens"], out["off"]["batch_tokens"])),
           **{k: v for k, v in on.items() if k != "batch_tokens"}}
    log(f"modes, preempt: {json.dumps(res)}")
    return res


def phase_modes(cfg, params) -> dict:
    """The engine's speculative and host-tier modes at Qwen2-7B (random
    bf16 weights), each engine built by the model server's ``build_engine``
    from its settings: default, SPEC_NGRAM_K=4, +SPEC_BURST_ITERS=4,
    +FUSED_STEP=1 with PREFILL_TOKEN_BUDGET=2048 on the modes traffic (bf16
    pages), then the fused step and the gather path over int4 pages (two
    sampled rows in the fused runs); launches pinned (A at S = 5, C in the
    fused bf16 run, never B in a spec run); bf16 divergences only at near
    ties; float32 identity at 2 layers; one burst and one fused step with no
    host sync; the host tier and preempt-to-host runs."""
    import torch

    from githubrepostorag_tpu_torch.serving import SamplingParams

    a, b, c = "fused_window_attention", "paged_attention_decode_staged", "packed_prefill_attention_seg"
    t_phase = time.monotonic()
    traffic = modes_traffic(cfg)
    prompts = traffic["wave"] + traffic["decode"]
    runs, tokens = {}, {}
    # the fused runs carry two sampled rows of the wave
    plan = [(name, env, (1, 3) if name == "fused" else (), params, traffic)
            for name, env in MODE_RUNS] + [
        ("fused_int4", {**MODE_RUNS[3][1], "KV_QUANT": "int4"}, (1, 3), params, traffic),
        ("default_int4", {"KV_QUANT": "int4"}, (), params, traffic)]
    narr, narr_traffic = narrator_params(params), narrator_traffic(cfg)
    plan += [(f"quoting_{name}", env, (), narr, narr_traffic)
             for name, env in MODE_RUNS if name in ("default", "burst", "fused")]
    sync_check = None
    for name, env, sampled, tree, tr in plan:
        t0 = time.monotonic()
        engine = mode_engine(cfg, tree, env)
        warm_s = time.monotonic() - t0
        run = serve_modes_traffic(engine, tr, sampled)
        n = run["launches"]
        spec = "SPEC_NGRAM_K" in env
        if not spec:
            pin_mode_launches(name, n, (a,), ())
        else:
            pin_mode_launches(name, n, (a, a + "@S5"), (b,))
        if name == "default":
            pin_mode_launches(name, n, (b,), ())
        if name == "fused":
            pin_mode_launches(name, n, (c,), ())
        if "int4" in name:
            pin_mode_launches(name, n, (a + "@int4",), (b, c))
        run["a_launches_per_token"] = n.get(a, 0) / max(1, sum(
            len(r.output_tokens) for r in run["results"]))
        if name in ("default", "spec", "burst", "fused", "fused_int4", "quoting_burst"):
            run["profile"] = profile_decode(engine, tr["decode"],
                                            SamplingParams(temperature=0.0, max_tokens=17))
        if name == "burst":
            sync_check = sync_free_bursts(engine, traffic)
        tokens[name] = {i: run["results"][i].output_tokens for i in run["greedy_rows"]}
        run["warmup_s"] = warm_s
        run["seconds"] = time.monotonic() - t0
        run["launches"] = {k: v for k, v in n.items() if v}
        del run["results"]
        runs[name] = run
        log(f"modes, {name}: {json.dumps({k: v for k, v in run.items() if k != 'greedy_rows'})}")
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    del narr
    gc.collect()
    torch.cuda.empty_cache()
    quoting = {k: tokens[f"quoting_{k}"] for k in ("default", "burst", "fused")}
    if not quoting["burst"] == quoting["fused"] == quoting["default"]:
        raise RuntimeError("the quoting model's greedy tokens differ between the default, "
                           "burst and fused engines")
    for k in ("quoting_burst", "quoting_fused"):
        if runs[k]["spec_accepted"] <= 0:
            raise RuntimeError(f"{k}: no draft accepted on the quoting traffic")
    plain = tokens["default"]
    n_wave = len(traffic["wave"])
    groups = [list(range(n_wave)), list(range(n_wave, len(prompts)))]
    divergence = check_bf16_divergence(
        params, cfg, groups, prompts, plain, {k: tokens[k] for k in ("spec", "burst", "fused")})
    log(f"modes, bf16 divergence: {json.dumps(divergence)}")
    out = {"runs": {k: {kk: vv for kk, vv in v.items() if kk != "greedy_rows"}
                    for k, v in runs.items()},
           "bf16_divergence": divergence, "sync_free_bursts": sync_check,
           "identical_to_default": {k: sum(tokens[k][i] == plain[i] for i in tokens[k])
                                    for k in ("spec", "burst", "fused")},
           "quoting_rows_identical": len(quoting["default"]),
           "int4_fused_vs_gather_tpot_ms": [runs["fused_int4"]["tpot_ms_p50"],
                                            runs["default_int4"]["tpot_ms_p50"]]}
    out["f32"] = f32_identity(cfg, params)
    out["tier"] = tier_run(cfg, params)
    out["preempt"] = preempt_run(cfg, params)
    mode_settings()
    out["seconds"] = time.monotonic() - t_phase
    log(f"modes phase: {out['seconds']:.1f} s")
    return out


# the draft controller's settings as a pod sets them (the JAX defaults)
DRAFT_SPEC = {"SPEC_K": "4", "SPEC_ITERS": "4"}


def draft_config(cfg):
    """Qwen2-0.5B's widths and depth with the target's vocabulary: the
    published 0.5B's 151,936 beside the 7B's 152,064 is refused by the
    reference's vocabulary rule (ROADMAP queue 3).  Untied, as
    ``write_checkpoint`` writes it."""
    import dataclasses

    from githubrepostorag_tpu_torch.models.qwen2 import Qwen2Config

    return dataclasses.replace(Qwen2Config.qwen2_0_5b(), vocab_size=cfg.vocab_size,
                               tie_word_embeddings=False)


def draft_tree(dcfg, kind: str, seed: int, device: str = "cuda", dtype=None) -> dict:
    """A draft's unfused tree: ``random`` from the seed; ``quoting`` the
    quoting construction at the draft's shapes (zero layers, lm_head the
    embedding rolled by one row: narrates t -> t+1, as the quoting target
    does); ``partial`` quoting but for the ids t % 8 == 0, whose column
    t + 2 is row t's (they draft t + 2) and whose column t + 1 is row
    t + 1's (t + 1 drafts itself): drafts run out at those ids."""
    import torch

    from githubrepostorag_tpu_torch.models.qwen2 import init_params

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    tree = init_params(dcfg, gen, device=device, dtype=dtype or torch.bfloat16)
    if kind == "random":
        return tree
    tree = narrator_params(tree)
    if kind == "partial":
        t = torch.arange(0, dcfg.vocab_size - 2, 8, device=device)
        tree["lm_head"][:, t + 2] = tree["embed"][t].t()
        tree["lm_head"][:, t + 1] = tree["embed"][t + 1].t()
    return tree


def record_rungs(engine) -> dict:
    """Count the draft length the engine's controller picks each dispatch."""
    picks: dict[int, int] = {}
    pick = engine._pick_spec_k

    def counted(running):
        k = pick(running)
        picks[k] = picks.get(k, 0) + 1
        return k

    engine._pick_spec_k = counted
    return picks


def draft_sync_free(engine, traffic: dict) -> dict:
    """One draft burst (k = 4, 4 iterations) on the engine's rows with
    ``torch.cuda.set_sync_debug_mode("error")``: any host sync inside
    raises.  The inputs are made before, the rows cancelled after."""
    import torch

    from githubrepostorag_tpu_torch.serving import SamplingParams
    from githubrepostorag_tpu_torch.serving.draft_spec import draft_spec_burst

    rids = [engine.add_request(p, SamplingParams(temperature=0.0, max_tokens=64))
            for p in traffic["decode"]]
    while any(r.state in ("waiting", "prefilling") for r in engine._requests.values()):
        engine.step()
    running = [r for r in engine._row_req.values() if r.state == "running"]
    w = engine._spec_window_rows(running)
    t = engine._tensor
    args = [t(w[k]) for k in ("hist", "hlens", "lens")]
    rest = [t(w[k]) for k in ("bt", "limits", "active")]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        toks, prop, *_ = draft_spec_burst(
            engine.params, engine.draft_params, engine.cfg, engine.draft_cfg, *args,
            engine._k_pages, engine._v_pages, engine._dk_pages, engine._dv_pages, *rest,
            n_iters=4, k=4, k_scales=engine._k_scales, v_scales=engine._v_scales)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    block = toks.flatten().cpu()
    for rid in rids:
        engine.cancel(rid)
    while engine.has_work():
        engine.step()
    if not ((block >= -1) & (block < engine.cfg.vocab_size)).all():
        raise RuntimeError("the draft burst under sync-debug mode returned tokens outside "
                           "the vocabulary")
    return {"rows": len(running), "tokens": int((block >= 0).sum()),
            "proposed": int(prop.sum()), "host_syncs": 0}


def draft_f32_identity(cfg, dcfg, device: str = "cuda") -> dict:
    """Exact identity in float32: the 7B target and the 0.5B-width random
    draft each cut to 2 layers, float32 weights and pages (kernel A's f32
    route), TF32 off, the acceptance floor at 0 (every token through a
    verify window); every greedy token equal to the default engine's."""
    import dataclasses

    import torch

    from githubrepostorag_tpu_torch.models.qwen2 import init_params
    from githubrepostorag_tpu_torch.serving import Engine, SamplingParams

    cfg2, dcfg2 = (dataclasses.replace(c, num_layers=2) for c in (cfg, dcfg))
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 79)
    t2 = init_params(cfg2, gen, device=device, dtype=torch.float32)
    d2 = draft_tree(dcfg2, "random", SEED + 71, device=device, dtype=torch.float32)
    traffic = modes_traffic(cfg)
    kw = dict(page_size=128, num_pages=256, max_num_seqs=8, prefill_chunk=512, decode_burst=8,
              max_seq_len=11712, kv_dtype=torch.float32, device=device)
    sp = SamplingParams(temperature=0.0, max_tokens=traffic["n_new"])
    tokens, launches, counts = {}, {}, {}
    for name, extra in (("default", {}), ("draft", dict(draft_params=d2, draft_cfg=dcfg2,
                                                        spec_accept_floor=0.0, spec_k=4,
                                                        spec_iters=4))):
        engine = Engine(t2, cfg2, **kw, **extra)
        reset_launches()
        res = engine.generate(traffic["wave"] + traffic["decode"], sp)
        torch.cuda.synchronize()
        launches[name] = read_launches()
        tokens[name] = [r.output_tokens for r in res]
        counts[name] = (engine.spec_proposed, engine.spec_accepted)
        del engine
    diff = [i for i, (x, y) in enumerate(zip(tokens["draft"], tokens["default"])) if x != y]
    if diff:
        raise RuntimeError(f"float32 draft rows {diff} differ from the default engine's")
    pin_mode_launches("f32 draft", launches["draft"], ("fused_window_attention@hd64",
                                                       "fused_window_attention@hd128"),
                      ("paged_attention_decode_staged",))
    out = {"rows_identical": len(tokens["default"]),
           "tokens_each": sum(len(t) for t in tokens["default"]),
           "proposed_accepted": counts["draft"]}
    log(f"draft, float32 (2 layers): {json.dumps(out)}")
    del t2, d2
    gc.collect()
    torch.cuda.empty_cache()
    return out


def draft_tier_run(cfg, params, device: str = "cuda") -> dict:
    """The host tier with the draft on, at 7B: the tier run's geometry (48
    device pages, 256 host, four 2048-token prefixes) with the target as
    its own draft (so acceptance reads the draft's KV: a draft page left
    behind would change it).  The first prefix, written back and reclaimed,
    faults back in: the same tokens and the same proposed / accepted as
    its first serve, and both pools' faulted pages byte-equal."""
    import torch

    from githubrepostorag_tpu_torch.ops.page_migration import gather_pages
    from githubrepostorag_tpu_torch.serving import Engine, SamplingParams
    from githubrepostorag_tpu_torch.serving.kv_cache import page_hashes

    engine = Engine(params, cfg, page_size=128, num_pages=48, max_num_seqs=8,
                    prefill_chunk=512, decode_burst=8, max_seq_len=11712, kv_tier="on",
                    kv_host_pool_pages=256, draft_params=params, draft_cfg=cfg, spec_k=4,
                    spec_iters=4, device=device)
    engine.warmup()
    rng = np.random.default_rng(SEED + 83)
    prefixes = [rng.integers(0, cfg.vocab_size, 2048).tolist() for _ in range(4)]
    sp = SamplingParams(temperature=0.0, max_tokens=32)
    al = engine._allocator
    hashes = page_hashes(prefixes[0], 128)[: (len(prefixes[0]) - 1) // 128]

    def pools(pages):
        idx = torch.tensor(pages, dtype=torch.int32, device=device)
        return [x.cpu() for x in (*gather_pages(engine._k_pages, engine._v_pages, idx)[:2],
                                  *gather_pages(engine._dk_pages, engine._dv_pages, idx)[:2])]

    first = engine.generate([prefixes[0]], sp)[0]
    engine.flush_kv_migrations()
    before = pools([al._hash_to_page[h] for h in hashes])
    for p in prefixes[1:]:
        engine.generate([p], sp)
        engine.flush_kv_migrations()
    if any(h in al._hash_to_page for h in hashes):
        raise RuntimeError("the first prefix kept device pages after three others")
    again = engine.generate([prefixes[0]], sp)[0]
    torch.cuda.synchronize()
    if again.faulted_pages <= 0:
        raise RuntimeError("the evicted prefix did not fault in")
    if again.output_tokens != first.output_tokens:
        raise RuntimeError("the faulted-in prefix's tokens differ from its first serve's")
    acc = [(r.spec_proposed, r.spec_accepted) for r in (first, again)]
    if acc[0] != acc[1] or acc[0][1] <= 0:
        raise RuntimeError(f"acceptance after the fault-in {acc[1]} differs from the first "
                           f"serve's {acc[0]}")
    after = pools([al._hash_to_page[h] for h in hashes])
    if not all(torch.equal(x, y) for x, y in zip(before, after)):
        raise RuntimeError("round-tripped KV pages (target or draft pools) are not byte-equal")
    if al.free_count != al.num_pages:
        raise RuntimeError("pages leaked after the draft tier run")
    out = {"prefix_pages": len(hashes), "faulted_pages": again.faulted_pages,
           "proposed_accepted_first_and_after": acc, "pools_byte_equal": 4,
           "writebacks": al.writebacks, "fault_ins": al.fault_ins}
    log(f"draft, host tier: {json.dumps(out)}")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_draft(cfg, params, device: str = "cuda") -> dict:
    """Draft-model speculation at Qwen2-7B (random bf16 weights) with a
    Qwen2-0.5B-width draft (see the module docstring), each engine built by
    the model server's build_engine from its settings, the draft loaded
    from a checkpoint written into a temp dir under _build/ (deleted
    after); the checks and numbers of each run, bf16 divergences at near
    ties only, float32 identity, the host tier and a sync-free burst."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from githubrepostorag_tpu_torch import kernels
    from githubrepostorag_tpu_torch.serving import SamplingParams

    a, b = "fused_window_attention", "paged_attention_decode_staged"
    t_phase = time.monotonic()
    dcfg = draft_config(cfg)
    traffic = modes_traffic(cfg)
    prompts = traffic["wave"] + traffic["decode"]
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="draft-", dir=kernels.BUILD_DIR))
    out = {"draft_config": {k: getattr(dcfg, k) for k in (
        "hidden_size", "num_layers", "num_heads", "num_kv_heads", "head_dim",
        "intermediate_size", "vocab_size")}, "checkpoints": {}, "runs": {}}
    runs, tokens = {}, {}
    narr = narrator_params(params)
    try:
        dirs = {}
        for kind, seed in (("random", SEED + 71), ("quoting", SEED + 73),
                           ("partial", SEED + 73)):
            t0 = time.monotonic()
            tree = draft_tree(dcfg, kind, seed, device=device)
            dirs[kind] = root / kind
            dirs[kind].mkdir()
            nbytes = write_checkpoint(dirs[kind], tree, dcfg)
            del tree
            torch.cuda.empty_cache()
            out["checkpoints"][kind] = {"bytes": nbytes, "write_s": time.monotonic() - t0}
        plan = [("default", params, None, {}), ("random", params, "random", {}),
                ("random_floor0", params, "random", {"SPEC_ACCEPT_FLOOR": "0"}),
                ("quoting", narr, "quoting", {}), ("partial", narr, "partial", {}),
                ("quoting_kv8", narr, "quoting", {"KV_QUANT": "int8"})]
        sync_check = None
        for name, tree, kind, env in plan:
            t0 = time.monotonic()
            if kind is not None:
                env = {**env, **DRAFT_SPEC, "SPEC_DRAFT_MODEL": str(dirs[kind])}
            engine = mode_engine(cfg, tree, env, device)
            warm_s = time.monotonic() - t0
            picks = record_rungs(engine) if kind else {}
            run = serve_modes_traffic(engine, traffic)
            n = run["launches"]
            if run["watchdog_compiles"] != 0:
                raise RuntimeError(f"draft {name}: the compile watchdog counted "
                                   f"{run['watchdog_compiles']} after warmup")
            if kind is None:
                pin_mode_launches(name, n, (a, b), ())
            else:
                if engine._dk_pages.dtype != torch.bfloat16:
                    raise RuntimeError(f"draft {name}: draft pools in {engine._dk_pages.dtype}")
                pin_mode_launches(name, n, (a + "@hd64", a + "@hd128", a + "@S1",
                                            a + "@S5"), ())
            if name == "random":
                pin_mode_launches(name, n, (b,), ())
                if engine.spec_fallbacks.get("acceptance", 0) <= 0:
                    raise RuntimeError("the random draft was never demoted by the floor")
            if name == "random_floor0":
                pin_mode_launches(name, n, (), (b,))
            if name == "quoting_kv8":
                pin_mode_launches(name, n, (a + "@int8",), ())
                if engine._k_pages.dtype != torch.int8:
                    raise RuntimeError("quoting_kv8: the target pages are not int8")
            rate = run["spec_accepted"] / max(1, run["spec_proposed"])
            run.update(warmup_s=warm_s, acceptance=rate, fallbacks=dict(engine.spec_fallbacks),
                       rungs={str(k): v for k, v in sorted(picks.items())},
                       a_launches_per_token=n.get(a, 0) / max(1, sum(
                           len(r.output_tokens) for r in run["results"])),
                       a_launches_by_head_dim={k: n.get(f"{a}@{k}", 0) for k in ("hd64",
                                                                               "hd128")},
                       a_launches_by_window={k.split("@S")[1]: v for k, v in n.items()
                                             if k.startswith(a + "@S")})
            if name in ("default", "random_floor0", "quoting"):
                run["profile"] = profile_decode(engine, traffic["decode"],
                                                SamplingParams(temperature=0.0, max_tokens=17))
            if name == "random":
                sync_check = draft_sync_free(engine, traffic)
            tokens[name] = {i: run["results"][i].output_tokens for i in run["greedy_rows"]}
            run["seconds"] = time.monotonic() - t0
            run["launches"] = {k: v for k, v in n.items() if v}
            del run["results"], run["greedy_rows"]
            runs[name] = run
            log(f"draft, {name}: {json.dumps(run)}")
            del engine
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
        mode_settings()
    del narr
    gc.collect()
    torch.cuda.empty_cache()
    if runs["quoting"]["acceptance"] < 0.9 or set(runs["quoting"]["rungs"]) != {"4"}:
        raise RuntimeError(f"quoting pair: acceptance {runs['quoting']['acceptance']:.3f}, "
                           f"rungs {runs['quoting']['rungs']}; expected ~1 at the top rung")
    part = runs["partial"]
    if not 0.0 < part["acceptance"] < runs["quoting"]["acceptance"] or \
            set(part["rungs"]) <= {"4"}:
        raise RuntimeError(f"partly quoting draft: acceptance {part['acceptance']:.3f}, "
                           f"rungs {part['rungs']}; expected partial, a lower rung visited")
    for name in ("partial", "quoting_kv8"):
        if tokens[name] != tokens["quoting"]:
            raise RuntimeError(f"{name}: greedy tokens differ from the quoting pair's")
    n_wave = len(traffic["wave"])
    groups = [list(range(n_wave)), list(range(n_wave, len(prompts)))]
    divergence = check_bf16_divergence(
        params, cfg, groups, prompts, tokens["default"],
        {k: tokens[k] for k in ("random", "random_floor0")}, device=device, widths=(2, 3, 5))
    log(f"draft, bf16 divergence: {json.dumps(divergence)}")
    out.update(runs=runs, bf16_divergence=divergence, sync_free_burst=sync_check,
               identical_to_default={k: sum(tokens[k][i] == tokens["default"][i]
                                            for i in tokens[k])
                                     for k in ("random", "random_floor0")})
    out["f32"] = draft_f32_identity(cfg, dcfg, device)
    out["tier"] = draft_tier_run(cfg, params, device)
    out["seconds"] = time.monotonic() - t_phase
    log(f"draft phase: {out['seconds']:.1f} s")
    return out


FLEET_KEYS = ("MESH_SHAPE", "FLEET_SPARES", "CTRL", "CTRL_TICK_S", "CTRL_HYSTERESIS_TICKS",
              "CTRL_COOLDOWN_S", "CTRL_LIVENESS_TIMEOUT_S", "CTRL_SNAPSHOT_DIR", "DISAGG",
              "DISAGG_PREFILL_REPLICAS", "ROUTE_DIGEST_INTERVAL_S", "FAULTS",
              "SLO_TTFT_P50_MS", "SLO_TTFT_P99_MS", "SLO_TPOT_MS")
FLEET_PREFIX = 1024  # the shared prefix of a group's prompts (tokens)
FLEET_NEW = 32  # greedy tokens a request


def fleet_settings(env: dict | None = None, geometry: dict | None = None):
    """``mode_settings`` with the fleet's settings unset but ``env``'s, and
    ``geometry`` (default: the engine phase's) in the environment."""
    import os

    from githubrepostorag_tpu_torch.resilience.faults import reset_faults

    for key in FLEET_KEYS:
        os.environ.pop(key, None)
    s = mode_settings({**(geometry or {}), **(env or {})})
    reset_faults()
    return s


def arm_faults(spec: str | None) -> None:
    """``FAULTS=spec`` (None: unset), the settings and the fault registry
    rebuilt from it, as a restarted pod would read it."""
    import os

    from githubrepostorag_tpu_torch import config
    from githubrepostorag_tpu_torch.resilience.faults import reset_faults

    if spec is None:
        os.environ.pop("FAULTS", None)
    else:
        os.environ["FAULTS"] = spec
    config.reload_settings()
    reset_faults()


def fleet_traffic(seed: int = SEED + 83, groups: int = 4, size: int = 4,
                  prefix: int = FLEET_PREFIX) -> dict:
    """``groups`` groups of ``size`` completion prompts (byte-tokenizer
    text: one token a byte) sharing a ``prefix``-token prefix, each with a
    100-300 token tail; and 8 distinct 256-token prompts (the decode wave)."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz  ,.", dtype=np.uint8)

    def text(n):
        return bytes(rng.choice(letters, n)).decode()

    out = []
    for _ in range(groups):
        head = text(prefix)
        out.append([head + text(int(rng.integers(100, 301))) for _ in range(size)])
    return {"groups": out, "decode": [text(256) for _ in range(8)]}


class LoopThread:
    """An event loop on a thread of its own (the server's), with ``run``
    for coroutines from this thread."""

    def __init__(self) -> None:
        import threading

        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, name="fleet-loop",
                                       daemon=True)
        self.thread.start()

    def run(self, coro, timeout: float = 600):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def close(self) -> None:
        self.run(self.loop.shutdown_asyncgens())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)
        self.loop.close()


def record_results(served) -> tuple[dict, list]:
    """Wrap ``served.stream`` (an AsyncEngine or a MultiAsyncEngine): every
    final result by request id, and the order in which requests met their
    first token (request id, monotonic time)."""
    results, firsts = {}, []
    inner = served.stream

    async def stream(*args, **kw):
        first = True
        async for event in inner(*args, **kw):
            if event.type == "token" and first:
                first = False
                firsts.append((kw.get("request_id"), time.monotonic()))
            if event.type == "final":
                results[event.result.request_id] = event.result
            yield event

    served.stream = stream
    return results, firsts


def wait_for(cond, timeout: float = 300, what: str = "condition") -> None:
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            raise RuntimeError(f"timed out waiting for {what}")
        time.sleep(0.002)


def send_groups(port: int, groups: list[list[str]], firsts: list,
                max_tokens: int = FLEET_NEW) -> list:
    """The group schedule over HTTP (``/v1/completions``, greedy): a group's
    first request alone; once it has its first token (its prefix pages
    registered and published), the group's other requests at once; the
    next group once every request of this one has its first token.
    Returns (status, reply, (start, end)) per request, in group order."""
    from concurrent.futures import ThreadPoolExecutor

    def post(prompt):
        body = json.dumps({"prompt": prompt, "max_tokens": max_tokens,
                           "temperature": 0}).encode()
        return _http(port, "POST", "/v1/completions", body)

    futures = []
    n0 = len(firsts)
    with ThreadPoolExecutor(sum(len(g) for g in groups)) as pool:
        done = 0
        for group in groups:
            futures.append(pool.submit(post, group[0]))
            wait_for(lambda: len(firsts) >= n0 + done + 1, what="a group's first token")
            time.sleep(0.05)  # the driver publishes its digest after the step
            futures += [pool.submit(post, p) for p in group[1:]]
            done += len(group)
            wait_for(lambda: len(firsts) >= n0 + done, what="the group's first tokens")
        return [f.result() for f in futures]


def served_numbers(replies: list, results: dict, t_start: float) -> dict:
    """TTFT (engine: submit to first token), client latency, decode tok/s
    (decode tokens over first token to last done) of one run's replies."""
    res = []
    for status, reply, _ in replies:
        if status != 200:
            raise RuntimeError(f"/v1/completions: {status} {reply}")
        r = results[reply["id"]]
        if r.finish_reason != "length" or len(r.output_tokens) != reply["usage"][
                "completion_tokens"]:
            raise RuntimeError(f"{reply['id']}: {r.finish_reason}, {len(r.output_tokens)} tokens")
        res.append(r)
    ttft = sorted(r.ttft_s for r in res)
    lat = sorted(end - start for _, _, (start, end) in replies)
    first = min(r.timings["first_token_t"] for r in res)
    done = max(r.timings["done_t"] for r in res)
    return {"requests": len(res), "ttft_p50_s": percentile(ttft, 0.5),
            "ttft_p95_s": percentile(ttft, 0.95), "latency_p50_s": percentile(lat, 0.5),
            "latency_p95_s": percentile(lat, 0.95),
            "decode_tok_s": sum(len(r.output_tokens) - 1 for r in res) / (done - first),
            "wall_s": done - t_start, "tokens": [r.output_tokens for r in res],
            "prompts": [list(r.prompt_tokens) for r in res]}


def serve_http(served, s) -> tuple:
    """OpenAIServer over ``served`` (byte tokenizer) on a loop thread."""
    from githubrepostorag_tpu_torch.serving.openai_api import OpenAIServer
    from githubrepostorag_tpu_torch.serving.tokenizer import ByteTokenizer

    lt = LoopThread()
    server = OpenAIServer(served, ByteTokenizer(), model_name=s.qwen_model)
    port = lt.run(server.start("127.0.0.1", 0))
    return lt, server, port


def decode_wave_profile(served, prompts: list[str], device: str) -> dict:
    """profile_decode's idle share for one or more driver threads: the
    decode wave (8 distinct 256-token prompts x 17 greedy tokens) at once
    through ``served``: warm, timed (wall), then under torch.profiler
    (device busy)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from githubrepostorag_tpu_torch.serving import SamplingParams

    sp = SamplingParams(temperature=0.0, max_tokens=17)
    ids = [list(p.encode()) for p in prompts]

    async def wave():
        return await asyncio.gather(*(served.generate(p, sp) for p in ids))

    lt = LoopThread()
    try:
        lt.run(wave())
        t0 = time.monotonic()
        lt.run(wave())
        wall = 1e3 * (time.monotonic() - t0)
        busy = None
        if device == "cuda":
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                lt.run(wave())
                torch.cuda.synchronize()
            busy = sum(e.self_device_time_total for e in prof.key_averages()
                       if "CUDA" in str(e.device_type)) / 1e3
        return {"wall_ms": wall, "busy_ms": busy,
                "idle_pct": None if busy is None else 100 * (1 - busy / wall)}
    finally:
        lt.run(served.stop())
        lt.close()


def pin_path(label: str, device: str) -> dict:
    """Kernels A and B launched on the path just served, nothing else."""
    launches = read_launches()
    if device == "cuda":
        a, b = "fused_window_attention", "paged_attention_decode_staged"
        pin_mode_launches(label, launches, (a, b), ())
        off = {k: n for k, n in launches.items() if k.split("@")[0] not in (a, b) and n}
        if off:
            raise RuntimeError(f"the {label} path launched kernels it never reaches: {off}")
    return {k: v for k, v in launches.items() if v}


def watchdog_counts(replicas) -> dict:
    from githubrepostorag_tpu_torch import metrics

    return {ae.replica: metrics.counter_value(metrics.XLA_COMPILES, replica=ae.replica)
            for ae in replicas}


def fleet_router_run(cfg, params, traffic: dict, device: str, geometry: dict | None) -> dict:
    """(a): one engine, then ``MESH_SHAPE=dp:2``, each built by the
    server's ``build_serving_engine`` and behind the model server over
    HTTP, on the same group schedule; the decode wave's idle share through
    each; the fleet's tokens against the one engine's; memory of one
    engine and of two replicas over the one weight tree.  Affinity is held
    to the router's own record: every group's first request misses, the
    other 12 hit, less the hits its ``router.pick`` events say it passed
    over for load (``slack_spill``)."""
    import torch

    from githubrepostorag_tpu_torch.serving.__main__ import build_serving_engine

    mem = (lambda: torch.cuda.memory_allocated()) if device == "cuda" else (lambda: 0)
    out = {}
    runs = {}
    for label, env in (("one_engine", {}), ("dp2", {"MESH_SHAPE": "dp:2"})):
        s = fleet_settings({**env, "ROUTE_DIGEST_INTERVAL_S": "0"}, geometry)
        m0 = mem()
        t0 = time.monotonic()
        served = build_serving_engine(s, params, cfg, torch.device(device),
                                      2 if env else 1)
        build_s = time.monotonic() - t0
        m1 = mem()
        replicas = served.replicas() if env else [served]
        results, firsts = record_results(served)
        lt, server, port = serve_http(served, s)
        try:
            compiles0 = watchdog_counts(replicas)
            reset_launches()
            t_start = time.monotonic()
            replies = send_groups(port, traffic["groups"], firsts)
            if device == "cuda":
                torch.cuda.synchronize()
            run = served_numbers(replies, results, t_start)
            run["launches"] = pin_path(f"fleet {label}", device)
            compiles = {r: n - compiles0[r] for r, n in watchdog_counts(replicas).items()}
            if any(compiles.values()):
                raise RuntimeError(f"fleet {label}: the watchdog counted {compiles} after warmup")
            run.update(build_s=build_s, memory_allocated_gb=m1 / 1e9,
                       engines_gb=(m1 - m0) / 1e9, watchdog_compiles=compiles)
            if env:
                router = served.router_stats()
                d = router["decisions"]
                timeline = _http(port, "GET", "/debug/timeline?window_s=600")[1]
                picks = [ev["args"] for ev in timeline["traceEvents"]
                         if ev.get("cat") == "fleet" and ev.get("name") == "router.pick"]
                spills = sum(1 for a in picks if a.get("slack_spill"))
                n_req = sum(len(g) for g in traffic["groups"])
                if len(picks) != n_req or d["affinity_hit"] + d["affinity_miss"] != n_req:
                    raise RuntimeError(f"dp:2: {len(picks)} router.pick events and "
                                       f"{d} decisions for {n_req} requests")
                if d["affinity_hit"] < n_req - len(traffic["groups"]) - spills or \
                        d["affinity_miss"] - spills != len(traffic["groups"]):
                    raise RuntimeError(f"dp:2: {d['affinity_hit']} affinity hits and "
                                       f"{d['affinity_miss']} misses, {spills} slack spills; "
                                       "expected a miss a group and the rest hits less the "
                                       "spills")
                fleet_payload = _http(port, "GET", "/debug/fleet")[1]
                health = _http(port, "GET", "/health")[1]
                if [r["replica"] for r in fleet_payload["replicas"]] != ["r0", "r1"] or \
                        health["replicas"] != 2 or "router" not in health:
                    raise RuntimeError("dp:2: /debug/fleet or /health misses a replica")
                run.update(decisions=d, spills=spills,
                           routed={r: v["routed"] for r, v in router["per_replica"].items()},
                           prefix_hit_rate={r: v["prefix_hit_rate"]
                                            for r, v in router["per_replica"].items()})
        finally:
            lt.run(server.stop())
            lt.close()
        routed0 = served.router_stats()["per_replica"] if env else {}
        run["decode_wave"] = decode_wave_profile(served, traffic["decode"], device)
        if env:  # the three waves' picks
            run["decode_wave"]["routed"] = {
                r: v["routed"] - routed0[r]["routed"]
                for r, v in served.router_stats()["per_replica"].items()}
        runs[label] = run
        if not env:
            # the disagg part's fused references, outside the numbers
            from githubrepostorag_tpu_torch.serving import SamplingParams

            sp = SamplingParams(temperature=0.0, max_tokens=FLEET_NEW)
            fault = [list(p.encode()) for p in fleet_traffic(SEED + 89, 1, 2)["groups"][0]]
            out["fault_prompts"] = fault
            out["fault_plain"] = [r.output_tokens for r in served.engine.generate(fault, sp)]
        del served, replicas, server
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        log(f"fleet, {label}: " + json.dumps({k: v for k, v in run.items()
                                              if k not in ("tokens", "prompts")}))
    one, dp2 = runs["one_engine"], runs["dp2"]
    n = len(traffic["groups"][0])
    groups = [list(range(i, i + n)) for i in range(0, len(one["tokens"]), n)]
    divergence = check_bf16_divergence(
        params, cfg, groups, one["prompts"], one["tokens"],
        {"dp2": dict(enumerate(dp2["tokens"]))}, device=device)
    out.update(one_engine={k: v for k, v in one.items() if k not in ("tokens", "prompts")},
               dp2={k: v for k, v in dp2.items() if k not in ("tokens", "prompts")},
               bf16_divergence=divergence, plain=one["tokens"], prompts=one["prompts"],
               extra_replica_gb=dp2["engines_gb"] - one["engines_gb"])
    return out


def fleet_f32_identity(cfg, params, device: str) -> dict:
    """Exact identity in float32: the 7B at full width cut to 2 layers,
    float32 weights and pages; two groups of the router traffic through a
    two-replica MultiAsyncEngine and through one AsyncEngine, every greedy
    token equal."""
    import dataclasses

    import torch

    from githubrepostorag_tpu_torch.serving import AsyncEngine, Engine, SamplingParams
    from githubrepostorag_tpu_torch.serving.multi_engine import MultiAsyncEngine

    cfg2 = dataclasses.replace(cfg, num_layers=2)
    p2 = upcast({**params, "layers": {k: v[:2] for k, v in params["layers"].items()}})
    kw = dict(page_size=128, num_pages=256, max_num_seqs=8, prefill_chunk=512, decode_burst=8,
              max_seq_len=11712, kv_dtype=torch.float32, device=device)
    groups = fleet_traffic(SEED + 83, 2)["groups"]
    sp = SamplingParams(temperature=0.0, max_tokens=FLEET_NEW)
    fleet_settings({"ROUTE_DIGEST_INTERVAL_S": "0"})
    tokens = {}
    for label, n in (("one", 1), ("dp2", 2)):
        engines = [Engine(p2, cfg2, **kw) for _ in range(n)]
        served = MultiAsyncEngine(engines) if n > 1 else AsyncEngine(engines[0])

        async def run():
            out = []
            for g in groups:
                ids = [list(p.encode()) for p in g]
                first = asyncio.ensure_future(served.generate(ids[0], sp))
                await asyncio.sleep(0.5)
                out += [await first] + list(await asyncio.gather(
                    *(served.generate(p, sp) for p in ids[1:])))
            await served.stop()
            return out

        tokens[label] = [r.output_tokens for r in asyncio.run(run())]
        del served, engines
    diff = [i for i, (x, y) in enumerate(zip(tokens["dp2"], tokens["one"])) if x != y]
    if diff:
        raise RuntimeError(f"float32 fleet rows {diff} differ from one engine's")
    del p2
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"rows_identical": len(tokens["one"]), "tokens_each": FLEET_NEW}


def fleet_disagg_run(cfg, params, traffic: dict, ref: dict, device: str,
                     geometry: dict | None) -> dict:
    """(b): ``DISAGG=on`` with ``KV_TIER=on``, two replicas (r0 prefill, r1
    decode) built by ``build_serving_engine``: two groups of the router
    traffic (handoffs, pages shipped, per-page export / import / fault-in
    ms and GB/s), the same again (every page deduped), the shipped pages
    byte-equal on both replicas, tokens against the one engine's (bf16:
    near ties only); then two new prompts under
    ``FAULTS=disagg.transfer:error``: the transfer_error fallback, the one
    engine's tokens."""
    import torch

    from githubrepostorag_tpu_torch.ops.page_migration import gather_pages
    from githubrepostorag_tpu_torch.serving import SamplingParams
    from githubrepostorag_tpu_torch.serving.__main__ import build_serving_engine
    from githubrepostorag_tpu_torch.serving.kv_cache import page_hashes

    s = fleet_settings({"MESH_SHAPE": "dp:2", "DISAGG": "on", "KV_TIER": "on",
                        "KV_HOST_POOL_PAGES": "512", "ROUTE_DIGEST_INTERVAL_S": "0"}, geometry)
    multi = build_serving_engine(s, params, cfg, torch.device(device), 2)
    pre, dec = multi.replicas()
    if (pre.role, dec.role) != ("prefill", "decode"):
        raise RuntimeError(f"disagg roles {pre.role} / {dec.role}")
    sp = SamplingParams(temperature=0.0, max_tokens=FLEET_NEW)
    groups = traffic["groups"][:2]
    n = len(groups[0])
    ids = [list(p.encode()) for g in groups for p in g]
    lt = LoopThread()

    async def serve_groups():
        out = []
        for i in range(0, len(ids), n):
            first = asyncio.ensure_future(multi.generate(ids[i], sp))
            # the group's followers once the first is decoding on r1
            while not (dec.engine.num_running or first.done()):
                await asyncio.sleep(0.002)
            await asyncio.sleep(0.05)
            out += [await first] + list(await asyncio.gather(
                *(multi.generate(p, sp) for p in ids[i + 1: i + n])))
        return out

    try:
        reset_launches()
        t0 = time.monotonic()
        first = lt.run(serve_groups())
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.monotonic() - t0
        ds1 = multi.disagg_stats()
        xfer = {"export_s": pre.engine.transfer_seconds_total,
                "exported": pre.engine.kv_pages_exported,
                "import_s": dec.engine.transfer_seconds_total,
                "imported": dec.engine.kv_pages_imported,
                "fault_in_s": dec.engine.fault_in_seconds_total,
                "faulted": dec.engine._allocator.fault_ins}
        again = lt.run(serve_groups())
        ds2 = multi.disagg_stats()
        launches = pin_path("disagg", device)
        # the first request's shipped pages, on both replicas
        hashes = page_hashes(ids[0], pre.engine.page_size)[: (len(ids[0]) - 1)
                                                            // pre.engine.page_size]
        lt.run(asyncio.sleep(0.1))
        byte_equal = 0
        for h in hashes:
            pages = [ae.engine._allocator.device_page_of(h) for ae in (pre, dec)]
            if None in pages:
                continue
            got = [gather_pages(ae.engine._k_pages, ae.engine._v_pages,
                                torch.tensor([p], dtype=torch.int32, device=device))[:2]
                   for ae, p in zip((pre, dec), pages)]
            if not all(torch.equal(x, y) for x, y in zip(*got)):
                raise RuntimeError("a shipped KV page differs between the two replicas")
            byte_equal += 1
        if byte_equal == 0:
            raise RuntimeError("no shipped page was resident on both replicas")
        # the fault case: new prompts, every transfer chunk refused
        arm_faults("disagg.transfer:error")
        fault_res = [lt.run(multi.generate(p, sp)) for p in ref["fault_prompts"]]
        arm_faults(None)
        ds3 = multi.disagg_stats()
    finally:
        arm_faults(None)
        lt.run(multi.stop())
        lt.close()
    page_bytes = 2 * pre.engine._k_pages[:, :, 0].numel() * pre.engine._k_pages.element_size()
    tokens = [r.output_tokens for r in first]
    if [r.output_tokens for r in again] != tokens:
        raise RuntimeError("disagg: the repeat round's tokens differ from the first round's")
    if ds1["handoffs"] != len(ids) or ds1["fallbacks"]:
        raise RuntimeError(f"disagg round 1: {ds1}")
    if ds2["pages_shipped"] != ds1["pages_shipped"] or ds2["pages_deduped"] <= ds1[
            "pages_deduped"]:
        raise RuntimeError(f"disagg repeat round shipped pages again: {ds2}")
    if ds3["fallbacks"].get("transfer_error") != len(fault_res):
        raise RuntimeError(f"disagg fault: fallbacks {ds3['fallbacks']}")
    plain = ref["plain"][: len(ids)]
    divergence = check_bf16_divergence(
        params, cfg, [list(range(i, i + n)) for i in range(0, len(ids), n)], ids, plain,
        {"disagg": dict(enumerate(tokens))}, device=device)
    # the fallback prefills on the prefill replica over its cached prefix
    fault_divergence = check_bf16_divergence(
        params, cfg, [[0, 1]], ref["fault_prompts"], ref["fault_plain"],
        {"fault": dict(enumerate(r.output_tokens for r in fault_res))}, device=device)
    out = {
        "handoffs": ds1["handoffs"], "pages_shipped": ds1["pages_shipped"],
        "pages_deduped_first_round": ds1["pages_deduped"],
        "repeat_round": {"handoffs": ds2["handoffs"] - ds1["handoffs"],
                         "pages_shipped": ds2["pages_shipped"] - ds1["pages_shipped"],
                         "pages_deduped": ds2["pages_deduped"] - ds1["pages_deduped"]},
        "transport": ds3["transport"], "fault_fallbacks": ds3["fallbacks"],
        "pages_byte_equal": byte_equal, "page_mb": page_bytes / 2 ** 20,
        "first_round_wall_s": wall, **xfer,
        "export_ms_per_page": 1e3 * xfer["export_s"] / max(1, xfer["exported"]),
        "export_gb_s": xfer["exported"] * page_bytes / max(1e-9, xfer["export_s"]) / 1e9,
        "import_ms_per_page": 1e3 * xfer["import_s"] / max(1, xfer["imported"]),
        "fault_in_ms_per_page": 1e3 * xfer["fault_in_s"] / max(1, xfer["faulted"]),
        "fault_in_gb_s": xfer["faulted"] * page_bytes / max(1e-9, xfer["fault_in_s"]) / 1e9,
        "tokens_equal_one_engine": sum(t == p for t, p in zip(tokens, plain)),
        "bf16_divergence": divergence, "fault_divergence": fault_divergence,
        "launches": launches,
    }
    del multi, pre, dec
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def fleet_controller_run(cfg, params, device: str, geometry: dict | None) -> dict:
    """(c): ``MESH_SHAPE=dp:3``, ``FLEET_SPARES=1``, ``CTRL=on`` behind the
    model server over HTTP, as ``python -m githubrepostorag_tpu_torch.
    serving`` builds them; a wave of 8 requests; once r0 has a first token,
    ``FAULTS=fleet.step.r0:error@window=3:`` kills its driver: r0 fenced,
    its requests answered with the fence's error, r2 activated, r0
    retired; a second wave served; seconds from the kill to r2 active and
    to the first request served after; failopen 0, the watchdog 0 across
    the activation, the action on /debug/fleet, the fence on
    /debug/timeline."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from githubrepostorag_tpu_torch.serving.__main__ import (build_controller,
                                                              build_serving_engine)

    # objectives no run misses, so the log holds the death rung alone: a
    # call on a slow host burned r1's TTFT / TPOT budget critical beside
    # the failover (the burn rung is held to JAX's by the CPU tests)
    s = fleet_settings({"MESH_SHAPE": "dp:3", "FLEET_SPARES": "1", "CTRL": "on",
                        "CTRL_TICK_S": "0.05", "CTRL_HYSTERESIS_TICKS": "2",
                        "CTRL_COOLDOWN_S": "30", "CTRL_LIVENESS_TIMEOUT_S": "30",
                        "SLO_TTFT_P50_MS": "600000", "SLO_TTFT_P99_MS": "600000",
                        "SLO_TPOT_MS": "600000"}, geometry)
    multi = build_serving_engine(s, params, cfg, torch.device(device), 3)
    r0, r1, r2 = multi.replicas()
    if [ae.lifecycle for ae in (r0, r1, r2)] != ["active", "active", "spare"]:
        raise RuntimeError("dp:3 with one spare: lifecycles wrong")
    results, firsts = record_results(multi)
    lt, server, port = serve_http(multi, s)
    ctrl = build_controller(s, multi)
    lt.run(ctrl.start())
    rng = np.random.default_rng(SEED + 97)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz  ,.", dtype=np.uint8)
    wave1 = [bytes(rng.choice(letters, 512)).decode() for _ in range(8)]
    wave2 = [bytes(rng.choice(letters, 512)).decode() for _ in range(4)]

    def post(prompt):
        body = json.dumps({"prompt": prompt, "max_tokens": 64, "temperature": 0}).encode()
        return _http(port, "POST", "/v1/completions", body)

    try:
        compiles0 = watchdog_counts((r1, r2))
        reset_launches()
        with ThreadPoolExecutor(8) as pool:
            futures = [pool.submit(post, p) for p in wave1]
            wait_for(lambda: any(multi._route.get(rid) is r0 for rid, _ in firsts),
                     what="r0's first token")
            arm_faults("fleet.step.r0:error@window=3:")
            wait_for(lambda: not r0.driver_alive(), what="r0's driver to die")
            t_kill = time.monotonic()
            wait_for(lambda: r2.lifecycle == "active" and r2.driver_alive()
                     and r0.lifecycle == "drained", what="the failover")
            t_active = time.monotonic()
            arm_faults(None)
            futures2 = [pool.submit(post, p) for p in wave2]
            replies1 = [f.result() for f in futures]
            replies2 = [f.result() for f in futures2]
        if device == "cuda":
            torch.cuda.synchronize()
        launches = pin_path("fleet controller", device)
        compiles = {r: n - compiles0[r] for r, n in watchdog_counts((r1, r2)).items()}
        payload = _http(port, "GET", "/debug/fleet")[1]
        timeline = _http(port, "GET", "/debug/timeline?window_s=600")[1]
    finally:
        ctrl.stop()
        lt.run(server.stop())
        lt.close()
        arm_faults(None)
    fenced = [r for r in replies1 if r[0] != 200]
    if not fenced or any(st != 400 or "fenced by fleet controller" not in rep["error"]["message"]
                         for st, rep, _ in fenced):
        raise RuntimeError(f"wave 1: r0's requests not answered with the fence's error: {fenced}")
    routed_r0 = sum(1 for r in replies1 if r[0] != 200)
    if any(st != 200 for st, _, _ in replies2):
        raise RuntimeError(f"wave 2 after the failover: {[r[:2] for r in replies2]}")
    res2 = [results[rep["id"]] for _, rep, _ in replies2]
    first_token = min(r.timings["first_token_t"] for r in res2)
    first_served = min(r.timings["done_t"] for r in res2)
    ctrl_section = payload["controller"]
    fo = [e for e in ctrl_section["log"] if e["action"] == "failover"]
    if [(e["replica"], e["reason"], e["status"]) for e in fo] != [("r0", "dead", "dispatched")]:
        raise RuntimeError(f"controller log: {ctrl_section['log']}")
    if ctrl_section["failopen"] != 0:
        raise RuntimeError(f"the controller failed open {ctrl_section['failopen']} times")
    if any(compiles.values()):
        raise RuntimeError(f"the watchdog counted {compiles} across the activation")
    names = {ev.get("name") for ev in timeline["traceEvents"]}
    if not {"fleet.fence", "request.fenced"} <= names:
        raise RuntimeError("/debug/timeline shows no fence")
    routed = {r: v["routed"] for r, v in payload["router"]["per_replica"].items()}
    if routed["r2"] < 1:
        raise RuntimeError("the activated spare served nothing")
    return {"kill_to_active_s": t_active - t_kill,
            "kill_to_first_token_s": first_token - t_kill,
            "kill_to_first_served_s": first_served - t_kill,
            "fenced_requests": routed_r0, "wave1_ok": len(replies1) - routed_r0,
            "wave2_ok": len(replies2), "routed": routed,
            "lifecycles": {r: v["lifecycle"] for r, v in payload["router"]["per_replica"].items()},
            "failover": fo[0]["detail"], "failopen": 0, "watchdog_compiles": compiles,
            "ticks": ctrl_section["ticks"], "launches": launches}


def phase_fleet(cfg, params, device: str = "cuda", geometry: dict | None = None) -> dict:
    """The fleet at Qwen2-7B (random bf16 weights; the engine phase's
    geometry: 256 pages of 128, 8 rows, chunk 512): (a) the router over
    ``MESH_SHAPE=dp:2`` against one engine, over HTTP, and in float32 at 2
    layers; (b) the disaggregated handoff; (c) the controller's failover.
    Every replica is built by the model server's ``build_serving_engine``
    over the one weight tree and launches A and B on the card's default
    stream."""
    import torch

    t0 = time.monotonic()
    traffic = fleet_traffic()
    out = {"router": fleet_router_run(cfg, params, traffic, device, geometry)}
    ref = {k: out["router"].pop(k) for k in ("plain", "prompts", "fault_prompts", "fault_plain")}
    out["f32"] = fleet_f32_identity(cfg, params, device) if device == "cuda" else None
    out["disagg"] = fleet_disagg_run(cfg, params, traffic, ref, device, geometry)
    log(f"fleet, disagg: {json.dumps(out['disagg'])}")
    out["controller"] = fleet_controller_run(cfg, params, device, geometry)
    log(f"fleet, controller: {json.dumps(out['controller'])}")
    fleet_settings()
    out["seconds"] = time.monotonic() - t0
    if device == "cuda":
        torch.cuda.empty_cache()
    log(f"fleet phase: {out['seconds']:.1f} s")
    return out


# ------------------------------------------------------------------- moe --

# the A2.7B's decode batch: its rows at one token each are the block's
# tokens, so a layer call with rows * K assignments is a decode step's
MOE_ROWS = 8
# the default pass serves the A2.7B at its published depth (--only moe too)
MOE_DEFAULT_LAYERS = 24


def moe_group1_cases(rng, dev, check) -> dict:
    """Kernels A and B at the Qwen1.5-MoE-A2.7B's attention: GQA group 1
    (16 query and 16 KV heads), hd 128, 128-key pages.  A at B=4, S=512,
    contexts to 4096 over fp, int8 and int4 pools; B at B=8, pool lengths
    to 8192 with 8 staged keys, over fp and int8 pools.  float32 for the
    tight limit, bf16 timed against its bound and SDPA.  Keys end in
    ``@g1``.  The whole script runs them in the kernel phase, while the
    profiler is fresh (late in a long process it has lost every record of
    a kernel in five traces running), ``--only moe`` in the moe phase."""
    import torch

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        timed, name = dtype == torch.bfloat16, str(dtype)[6:]
        case = kernel_a_case(rng, dev, 4, 512, 16, 16, 128, 128, cached=[3584, 2048, 512, 0],
                             new=[512, 512, 300, 512], dtype=dtype)
        for quant in (0, 8, 4):
            qcase = case if quant == 0 else quantized_case(case, quant)
            tag = "" if quant == 0 else f"@int{quant}"
            res = check(f"kernel A{tag.replace('@', ' ')} group 1 B=4 S=512 16/16 ctx<=4096 "
                        f"{name}", measure_kernel_a(qcase, timed))
            if timed:
                out[f"fused_window_attention{tag}@g1"] = res
        del case
        case = kernel_b_case(rng, dev, MOE_ROWS, 16, 16, 128, 128,
                             [8192, 6000, 4096, 3000, 2048, 1024, 300, 1], n_steps=8,
                             staged_len=8, dtype=dtype)
        for quant in (0, 8):
            qcase = case if quant == 0 else quantized_case(case, 8, n_layers=2)
            tag = "" if quant == 0 else "@int8"
            res = check(f"kernel B{tag.replace('@', ' ')} group 1 B=8 16/16 pool<=8192 "
                        f"staged 8 {name}", measure_kernel_b(qcase, timed))
            if timed:
                out[f"paged_attention_decode_staged{tag}@g1"] = res
        del case
    return out


def moe_config(layers: int | None = None):
    """Qwen1.5-MoE-A2.7B's published geometry (60 experts top-4, a shared
    expert, capacity factor 2.0), cut to ``layers``."""
    import dataclasses

    from githubrepostorag_tpu_torch.models.qwen2 import Qwen2Config

    cfg = Qwen2Config.qwen1_5_moe_a2_7b()
    return cfg if layers is None else dataclasses.replace(cfg, num_layers=layers)


def moe_tree(cfg, seed: int, dtype, fuse: bool = True, device: str = "cuda") -> dict:
    """Random weights at ``cfg`` drawn on the card from a seeded
    ``torch.Generator('cuda')``; fused (the serving layout) by default."""
    import torch

    from githubrepostorag_tpu_torch.models.quant import fuse_projections
    from githubrepostorag_tpu_torch.models.qwen2 import init_params

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = init_params(cfg, gen, device=device, dtype=dtype)
    return fuse_projections(params, in_place=True) if fuse else params


@contextlib.contextmanager
def plain_attention():
    """The paged path's attention through the plain versions of kernels A
    and B (the comparison path of the float32 engine check)."""
    from githubrepostorag_tpu_torch.models import qwen2
    from githubrepostorag_tpu_torch.ops.fused_decode import fused_window_attention_ref
    from githubrepostorag_tpu_torch.ops.paged_decode import paged_attention_decode_staged_ref
    from githubrepostorag_tpu_torch.serving import decode_burst

    saved = qwen2.fused_paged_attention, decode_burst.paged_attention_decode_staged
    qwen2.fused_paged_attention = fused_window_attention_ref
    decode_burst.paged_attention_decode_staged = paged_attention_decode_staged_ref
    try:
        yield
    finally:
        qwen2.fused_paged_attention, decode_burst.paged_attention_decode_staged = saved


def moe_f32_check(device: str = "cuda") -> dict:
    """The A2.7B at its widths cut to 2 layers, float32 weights and pages
    (kernels A's and B's f32 routes), TF32 off: ``forward_paged`` prefill
    logits with the kernels against the plain path (``check_f32_logits``),
    then an engine's greedy tokens with the kernels against the same engine
    run through the kernels' plain versions, every row equal, A and B
    launched in the first run and not in the second.  Routing is a
    discrete choice: a token whose experts or kept assignments differ
    between the two paths in some layer sat at a near tie (its router
    inputs differ by the f32 summation order), so the logits check covers
    the tokens routed alike, and the rerouted ones are counted (at most 1 %
    of the tokens)."""
    import torch

    from githubrepostorag_tpu_torch.models import moe
    from githubrepostorag_tpu_torch.models.qwen2 import forward_paged
    from githubrepostorag_tpu_torch.serving import Engine, SamplingParams
    from githubrepostorag_tpu_torch.serving.kv_cache import make_page_pools, slot_mapping

    cfg = moe_config(2)
    params = moe_tree(cfg, SEED + 90, torch.float32, device=device)
    dev = torch.device(device)
    rng = np.random.default_rng(SEED + 91)
    b, s, ps = 2, 512, 128
    new = [512, 300]
    ids = np.zeros((b, s), dtype=np.int32)
    slots = np.full((b, s), -1, dtype=np.int32)
    bt = np.asarray([[0, 1, 2, 3], [7, 6, 5, 4]], dtype=np.int32)
    for i, n in enumerate(new):
        ids[i, :n] = rng.integers(0, cfg.vocab_size, n)
        slots[i] = slot_mapping(bt[i], 0, n, ps, s)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    valid = torch.zeros((b, s), dtype=torch.bool, device=dev)
    for i, n in enumerate(new):
        valid[i, :n] = True
    logits, routes = {}, {}
    real_route = moe.route
    for use_kernels in (True, False):
        routes[use_kernels] = []

        def recording(*args, _out=routes[use_kernels]):
            top_p, top_i = real_route(*args)
            _out.append(top_i)
            return top_p, top_i

        pools = make_page_pools(cfg, 8, ps, dtype=torch.float32, device=dev)
        moe.route = recording
        try:
            out, _, _ = forward_paged(params, cfg, t(ids), t(pos), pools.k, pools.v, t(slots),
                                      t(bt), t(np.zeros(b, np.int32)),
                                      t(np.asarray(new, np.int32)), use_kernels=use_kernels)
        finally:
            moe.route = real_route
        logits[use_kernels] = out[valid]
        if not torch.isfinite(logits[use_kernels]).all():
            raise RuntimeError("non-finite MoE logits")
    alike = torch.ones(b * s, dtype=torch.bool, device=dev)
    for ti_k, ti_p in zip(routes[True], routes[False]):
        keep_k, keep_p = (moe.queue_slots(cfg, ti)[1].view(b * s, -1) for ti in (ti_k, ti_p))
        alike &= (ti_k == ti_p).all(-1) & (keep_k == keep_p).all(-1)
    alike = alike[valid.reshape(-1)]
    rerouted = int((~alike).sum())
    err = rel(logits[True], logits[False])
    log(f"MoE f32 logits: {rerouted} of {alike.numel()} tokens rerouted between the paths; "
        f"rel err over every token {err:.3g}")
    if rerouted > 0.01 * alike.numel():
        raise RuntimeError(f"{rerouted} of {alike.numel()} tokens routed differently with the "
                           "kernels than on the plain path")
    check_f32_logits("MoE A2.7B 2 layers forward_paged (tokens routed alike)",
                     logits[True][alike], logits[False][alike])

    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (600, 130, 300)]
    sp = SamplingParams(temperature=0.0, max_tokens=16)
    runs = {}
    for name in ("kernels", "plain"):
        engine = Engine(params, cfg, page_size=128, num_pages=64, max_num_seqs=4,
                        prefill_chunk=512, decode_burst=8, max_seq_len=2048,
                        kv_dtype=torch.float32, device=device)
        with plain_attention() if name == "plain" else contextlib.nullcontext():
            reset_launches()
            res = engine.generate(prompts, sp)
            torch.cuda.synchronize()
            runs[name] = ([r.output_tokens for r in res], read_launches())
        del engine
    a, b_ = "fused_window_attention", "paged_attention_decode_staged"
    (tok_k, n_k), (tok_p, n_p) = runs["kernels"], runs["plain"]
    if n_k[a] <= 0 or n_k[b_] <= 0 or n_p[a] or n_p[b_]:
        raise RuntimeError(f"MoE f32 engine launches: kernels run A {n_k[a]} B {n_k[b_]}, "
                           f"plain run A {n_p[a]} B {n_p[b_]}")
    diff = [i for i, (x, y) in enumerate(zip(tok_k, tok_p)) if x != y]
    if diff or any(len(x) != 16 for x in tok_k):
        raise RuntimeError(f"MoE f32 greedy rows {diff} differ between the kernels and the "
                           "plain path")
    out = {"logits_rel_err": err, "logits_rel_err_routed_alike": rel(logits[True][alike],
                                                                      logits[False][alike]),
           "tokens_rerouted": rerouted, "tokens": alike.numel(), "rows_identical": len(tok_k),
           "tokens_each": len(tok_k[0]), "launches": {a: n_k[a], b_: n_k[b_]}}
    log(f"MoE float32 (2 layers): {json.dumps(out)}")
    del params, logits
    gc.collect()
    torch.cuda.empty_cache()
    return out


class MoeProbe:
    """The MoE block's per-call (assignments, dropped) during the engine
    phase's timed traffic (``MOE_DROP_STATS`` on between ``reset()`` and
    ``read()``), and the profiler split of a decode batch (``after``)."""

    def __init__(self, cfg):
        from githubrepostorag_tpu_torch.models import moe

        self.cfg, self.moe, self.calls = cfg, moe, []
        self._record = moe._record_drops
        self._env = None

    def _recording(self, assignments, dropped) -> None:
        self.calls.append((int(assignments), int(dropped)))
        self._record(assignments, dropped)

    def reset(self) -> None:
        import os

        self.calls = []
        self._env = os.environ.get("MOE_DROP_STATS")
        os.environ["MOE_DROP_STATS"] = "1"
        self.moe._record_drops = self._recording

    def read(self) -> dict:
        import os

        self.moe._record_drops = self._record
        if self._env is None:
            os.environ.pop("MOE_DROP_STATS", None)
        else:
            os.environ["MOE_DROP_STATS"] = self._env
        decode_t = MOE_ROWS * self.cfg.num_experts_per_tok
        out = {}
        for phase, calls in (("prefill", [c for c in self.calls if c[0] != decode_t]),
                             ("decode", [c for c in self.calls if c[0] == decode_t])):
            offered, dropped = sum(c[0] for c in calls), sum(c[1] for c in calls)
            out[phase] = {"layer_calls": len(calls), "assignments": offered, "dropped": dropped,
                          "dropped_share": dropped / offered if offered else None}
        return out

    def after(self, engine, prompts, sp) -> dict:
        return {"device_split": moe_profile_split(engine, prompts, sp)}


def moe_profile_split(engine, prompts, sp) -> dict:
    """Where an MoE decode batch's device time goes: a torch.profiler trace
    (CPU ops and the card's kernels) of ``engine.generate(prompts, sp)``,
    each op's own device time put in the innermost of three ranges opened
    around the MoE block's parts (the router, the shared expert's
    projections, the whole block): the experts' ``bmm``s, the router, the
    dispatch / combine ops (the rest of the block), the shared expert;
    outside the block the dense projections (``mm``: attention and the
    logits), other ops; kernels A and B by name (no op launches them).
    Busy is the sum of these (``profile_decode``'s kernel total for the
    same batch should come out alike), idle one minus busy over the same
    call's unprofiled wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from githubrepostorag_tpu_torch.models import moe, qwen2

    def run():
        res = engine.generate(prompts, sp)
        torch.cuda.synchronize()
        return res

    run()
    t0 = time.monotonic()
    res = run()
    wall_ms = (time.monotonic() - t0) * 1e3
    tpot_ms = 1e3 * sorted(r.decode_time_s / (len(r.output_tokens) - 1)
                           for r in res)[len(res) // 2]
    real_mlp, real_route = qwen2.moe_mlp, moe.route

    def traced_mlp(cfg, p, x, mm=moe.qmatmul, mesh=None):
        def shared(a, w):
            with record_function("moe.shared_expert"):
                return mm(a, w)

        with record_function("moe.block"):
            return real_mlp(cfg, p, x, shared, mesh=mesh)

    def traced_route(*args):
        with record_function("moe.router"):
            return real_route(*args)

    qwen2.moe_mlp, moe.route = traced_mlp, traced_route
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
    finally:
        qwen2.moe_mlp, moe.route = real_mlp, real_route
    kernels = [e for e in prof.key_averages() if "CUDA" in str(e.device_type)]
    by_name = {"A": sum(e.self_device_time_total for e in kernels if kernel_of(e.key) == "A"),
               "B": sum(e.self_device_time_total for e in kernels
                        if any(n in e.key for n in B_KERNEL_NAMES))}
    ranges = ("moe.router", "moe.shared_expert", "moe.block")
    split = dict.fromkeys(("expert_bmm", "router", "dispatch_combine", "shared_expert",
                           "dense_projections", "other_ops", "unattributed_launches"), 0.0)
    for e in prof.events():
        if "CUDA" in str(e.device_type) or not e.self_device_time_total:
            continue
        op, where, node = None, None, e
        while node is not None:
            if op is None and node.name.startswith("aten::"):
                op = node.name
            if where is None and node.name in ranges:
                where = node.name
            node = node.cpu_parent
        t = e.self_device_time_total
        if where == "moe.router":
            split["router"] += t
        elif where == "moe.shared_expert":
            split["shared_expert"] += t
        elif where == "moe.block":
            split["expert_bmm" if op == "aten::bmm" else "dispatch_combine"] += t
        elif op is None:
            split["unattributed_launches"] += t
        elif "mm" in op and "bmm" not in op:
            split["dense_projections"] += t
        else:
            split["other_ops"] += t
    # A and B launch through ctypes, outside every op: they count by name
    busy_us = sum(split.values()) + by_name["A"] + by_name["B"]
    out = {"rows": len(prompts), "new_tokens": sp.max_tokens, "wall_ms": wall_ms,
           "tpot_ms_p50": tpot_ms,
           "busy_ms": busy_us / 1e3, "idle_pct": 100 * (1 - busy_us / 1e3 / wall_ms),
           "kernel_a_ms": by_name["A"] / 1e3, "kernel_b_ms": by_name["B"] / 1e3,
           **{f"{k}_ms": v / 1e3 for k, v in split.items()}}
    out["expert_bmm_share_of_busy"] = split["expert_bmm"] / busy_us if busy_us else None
    log(f"MoE decode split: {json.dumps(out)}")
    return out


def moe_serve(layers: int) -> dict:
    """The A2.7B at its published widths and ``layers`` deep, random bf16
    weights drawn on the card, served by the engine phase (256 pages of
    128, 8 rows, chunk 512; its traffic: a 5-request wave, a streamed
    request on a cached prefix, 8 x 64 decode) with capacity factor 2.0 and
    ``MOE_DROP_STATS`` on during the traffic: TTFT, TPOT, decode tok/s,
    peak memory, the share of assignments dropped at prefill and at decode,
    the decode batch's device split.  A and B launch once a layer per
    prefill forward and per decode step: their counts must equal the MoE
    block's layer calls of each kind in the same window."""
    import torch

    cfg = moe_config(layers)
    t0 = time.monotonic()
    params = moe_tree(cfg, SEED + 92, torch.bfloat16)
    torch.cuda.synchronize()
    n = sum(sum(f.numel() for f in (v if isinstance(v, tuple) else (v,)))
            for v in [params["embed"], params["norm"], params["lm_head"],
                      *params["layers"].values()])
    log(f"Qwen1.5-MoE-A2.7B random bf16 weights, {layers} layers: {n / 1e9:.2f} B params, "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB on the card, in "
        f"{time.monotonic() - t0:.1f} s")
    a, b = "fused_window_attention", "paged_attention_decode_staged"
    probe = MoeProbe(cfg)
    # the probe's device split profiles the decode batch (profile_decode's
    # kernel totals, idle share and TPOT are among its numbers)
    stats = phase_engine(cfg, params, f"MoE A2.7B {layers} layers bf16", (a, b),
                         ("packed_prefill_attention_seg", "int4_matmul", "w4a8_matmul",
                          "paged_attention_decode"), profile=False, probe=probe)
    drops = stats["probe"]
    launches = stats["launches"]
    if (launches[a] != drops["prefill"]["layer_calls"]
            or launches[b] != drops["decode"]["layer_calls"]):
        raise RuntimeError(f"MoE path: A launched {launches[a]} times for "
                           f"{drops['prefill']['layer_calls']} prefill layer calls, B "
                           f"{launches[b]} for {drops['decode']['layer_calls']} decode layer calls")
    stats.update({"layers": layers, "params_b": n / 1e9,
                  "prefill_forwards": launches[a] // layers,
                  "decode_steps": launches[b] // layers})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return stats


def moe_checkpoint_chat(layers: int = 2, device: str = "cuda") -> dict:
    """A Qwen2-MoE checkpoint at the A2.7B's widths cut to ``layers``
    (random bf16 weights, HF ``Qwen2MoeForCausalLM`` names, written by the
    port's writer with a byte-level tokenizer) loaded as the model server
    loads it (``load_qwen2`` with ``MOE_CAPACITY_FACTOR``), served by its
    ``build_serving_engine`` behind ``OpenAIServer`` on localhost: one
    ``POST /v1/chat/completions``, greedy, 16 tokens, through A and B."""
    import os
    import shutil
    import tempfile
    import threading
    from pathlib import Path

    import torch

    from githubrepostorag_tpu_torch import config, kernels
    from githubrepostorag_tpu_torch.models.hf_loader import load_qwen2
    from githubrepostorag_tpu_torch.serving.__main__ import build_serving_engine
    from githubrepostorag_tpu_torch.serving.openai_api import OpenAIServer
    from githubrepostorag_tpu_torch.serving.tokenizer import make_tokenizer

    cfg = moe_config(layers)
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="moe-ckpt-", dir=kernels.BUILD_DIR))
    saved = {k: os.environ.get(k) for k in (*ENGINE_GEOMETRY, "MODEL_WEIGHTS_PATH")}
    stats = {}
    loop = thread = server = None
    try:
        t0 = time.monotonic()
        params = moe_tree(cfg, SEED + 93, torch.bfloat16, fuse=False, device=device)
        stats["checkpoint_gb"] = write_checkpoint(root, params, cfg) / 1e9
        write_byte_tokenizer(root, cfg.vocab_size)
        del params
        torch.cuda.empty_cache()
        stats["write_s"] = time.monotonic() - t0
        os.environ.update({**ENGINE_GEOMETRY, "MODEL_WEIGHTS_PATH": str(root)})
        s = config.reload_settings()
        tok = make_tokenizer(s.model_weights_path)
        t0 = time.monotonic()
        loaded, lcfg = load_qwen2(s.model_weights_path, dtype=torch.bfloat16,
                                  quantize=s.quantize_weights, fuse=True, device=device,
                                  moe_capacity_factor=s.moe_capacity_factor)
        stats["load_s"] = time.monotonic() - t0
        if lcfg != cfg:
            raise RuntimeError(f"loaded config {lcfg} differs from the written {cfg}")
        aeng = build_serving_engine(s, loaded, lcfg, torch.device(device))
        del loaded
        server = OpenAIServer(aeng, tok, model_name=s.qwen_model)
        loop = asyncio.new_event_loop()
        thread = threading.Thread(target=loop.run_forever, name="moe-http", daemon=True)
        thread.start()
        port = asyncio.run_coroutine_threadsafe(server.start("127.0.0.1", 0), loop).result(600)
        body = json.dumps({"messages": [{"role": "user", "content": "explain the repo layout"}],
                           "max_tokens": 16, "temperature": 0}).encode()
        reset_launches()
        status, reply, (start, end) = _http(port, "POST", "/v1/chat/completions", body)
        torch.cuda.synchronize()
        launches = read_launches()
        a, b = "fused_window_attention", "paged_attention_decode_staged"
        if (status != 200 or reply["usage"]["completion_tokens"] < 1
                or reply["choices"][0]["finish_reason"] not in ("length", "stop")):
            raise RuntimeError(f"MoE chat completion: {status} {reply}")
        if launches[a] <= 0 or (reply["usage"]["completion_tokens"] > 1 and launches[b] <= 0):
            raise RuntimeError(f"the MoE server path launched A {launches[a]}, B {launches[b]} "
                               "times")
        stats.update({"status": status, "latency_s": end - start,
                      "prompt_tokens": reply["usage"]["prompt_tokens"],
                      "completion_tokens": reply["usage"]["completion_tokens"],
                      "finish_reason": reply["choices"][0]["finish_reason"],
                      "capacity_factor": lcfg.capacity_factor,
                      "launches": {a: launches[a], b: launches[b]}})
    finally:
        if server is not None:
            asyncio.run_coroutine_threadsafe(server.stop(), loop).result(120)
        if loop is not None:
            loop.call_soon_threadsafe(loop.stop)
            thread.join(30)
            loop.close()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        config.reload_settings()
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    log(f"MoE checkpoint served over HTTP: {json.dumps(stats)}")
    return stats


def release_planes() -> None:
    """Drop the port's process-wide observability registrations.  Every
    AsyncEngine registers its ledger, SLO monitor, page observatory and
    profiler there (the last one of a replica name stays), and a
    registration keeps its engine, weights and pools alive after the phase
    that built it."""
    from githubrepostorag_tpu_torch.obs import continuous, hbm, slo, timeline

    slo.reset_slo_plane()
    hbm.reset_hbm_plane()
    continuous.reset_profilers()
    timeline.reset_fleet_events_provider()


def phase_moe(layers: int | None = None, kernels: dict | None = None) -> dict:
    """The Qwen2-MoE family on the card: kernels A and B at the A2.7B's
    group-1 attention against their plain versions (``kernels``: the
    kernel phase's results of them, else run here); float32 logits and
    greedy tokens at 2 layers, kernels against the plain path; the A2.7B at
    its published widths served by the engine, ``layers`` deep (its
    published 24 by default); a 2-layer MoE checkpoint loaded and served
    over HTTP by the model server's entry points."""
    import torch

    t0 = time.monotonic()
    release_planes()  # one model's weights at a time: earlier engines go
    gc.collect()
    torch.cuda.empty_cache()
    log(f"moe phase: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated on the card "
        "before its first tree")
    checks = []

    def check(label, res):
        checks.append((label, res))
        log(f"{label}: {json.dumps(res)}")
        return res

    if kernels is None:
        kernels = moe_group1_cases(np.random.default_rng(SEED + 89), torch.device("cuda"), check)
    bad = [label for label, r in checks if not r["limit_share"] <= 1.0]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions at group 1: {bad}")
    out = {"kernels": kernels}
    out["f32"] = moe_f32_check()
    layers = moe_config().num_layers if layers is None else layers
    out["serve"] = moe_serve(layers)
    out["http"] = moe_checkpoint_chat()
    out["seconds"] = time.monotonic() - t0
    log(f"moe phase: {out['seconds']:.1f} s ({layers} of "
        f"{moe_config().num_layers} layers served)")
    return out


# ------------------------------------------------------------- training --

# float32 rate of one H100 SXM outside the tensor cores (NVIDIA data
# sheet, dense, at 700 W): the train step runs IEEE float32 (no TF32)
PEAK_F32_FLOPS = 66.9e12
# the card's step against the CPU's (2 layers, IEEE float32 on both): the
# same arithmetic summed in other orders (cuBLAS, the CPU's GEMMs)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-4  # of each leaf's largest |gradient|
# parameters after one AdamW(1e-4) update: within TRAIN_PARAM_ATOL plus,
# element by element, lr / eps times the gradients' difference (Adam's
# first update is lr g / (|g| + eps), steep where |g| is near eps)
TRAIN_PARAM_ATOL = 1e-6
TRAIN_LR, TRAIN_EPS = 1e-4, 1e-8
TRAIN_CHECK_LAYERS = 2


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def train_flops(cfg, rows: int, seq: int) -> float:
    """Model FLOPs of one train step with remat: 6 N (N every matmul
    weight, the tied embedding as the logits matrix), the layers'
    recomputed forward (2 N of the layers), and causal attention's QK and
    PV over S/2 keys on average, forward, recompute and backward (4 x)."""
    d, hd, inter = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    layer = d * nq * hd * 2 + d * nkv * hd * 2 + 3 * d * inter
    n_layers = cfg.num_layers * layer
    n = n_layers + d * cfg.vocab_size
    attn = cfg.num_layers * 4 * nq * hd * (seq / 2)  # QK and PV, 2 FLOPs a MAC
    return rows * seq * (6 * n + 2 * n_layers + 4 * attn)


def train_batch(cfg, rows: int, seq: int, device, seed: int) -> dict:
    """A fixed seeded batch: next-token targets, every position counted."""
    import torch

    ids = torch.randint(0, cfg.vocab_size, (rows, seq), generator=torch.Generator().manual_seed(seed))
    return {"input_ids": ids.to(device), "targets": torch.roll(ids, -1, 1).to(device),
            "mask": torch.ones_like(ids).to(device)}


def one_step(cfg, params: dict, batch: dict, mesh=None) -> tuple:
    """The loss, the gradients and the parameters after one AdamW step, from
    a copy of ``params`` (on their device)."""
    from githubrepostorag_tpu_torch.parallel.sharding import tree_map
    from githubrepostorag_tpu_torch.training import make_train_step, value_and_grad
    from githubrepostorag_tpu_torch.training.step import leaves

    params = tree_map(lambda t: t.clone(), params)
    loss, grads = value_and_grad(params, cfg, mesh, batch)
    step, opt = make_train_step(cfg, mesh)
    params, _, _ = step(params, opt(leaves(params)), batch)
    return loss, grads, params


def compare_steps(a: tuple, b: tuple) -> dict:
    """Step ``a`` against step ``b`` (the reference): the loss's relative
    error, each gradient's error over its leaf's max |g|, the parameters'
    error beside their limit (module constants); raises past any limit."""
    from githubrepostorag_tpu_torch.training.step import leaves

    (la, ga, pa), (lb, gb, pb) = a, b
    out = {"loss": float(lb), "loss_rel_err": abs(float(la) - float(lb)) / abs(float(lb)),
           "grad_err_share": 0.0, "param_max_abs_err": 0.0, "params_over_atol": 0}
    for x, y, p, q in zip(leaves(ga), leaves(gb), leaves(pa), leaves(pb)):
        x, y, p, q = (t.detach().float().cpu() for t in (x, y, p, q))
        gdiff = (x - y).abs()
        out["grad_err_share"] = max(out["grad_err_share"],
                                    float(gdiff.max() / (TRAIN_GRAD_RTOL * y.abs().max())))
        pdiff = (p - q).abs()
        if not bool((pdiff <= TRAIN_PARAM_ATOL + TRAIN_LR / TRAIN_EPS * gdiff).all()):
            raise RuntimeError(f"parameters after the step disagree: {float(pdiff.max())}")
        out["param_max_abs_err"] = max(out["param_max_abs_err"], float(pdiff.max()))
        out["params_over_atol"] += int((pdiff > TRAIN_PARAM_ATOL).sum())
    if not (out["loss_rel_err"] <= TRAIN_LOSS_RTOL and out["grad_err_share"] <= 1.0):
        raise RuntimeError(f"the step disagrees: {json.dumps(out)}")
    return out


def train_checks(cfg, device) -> dict:
    """At 2 layers of the model's widths, float32: one step on ``device``
    against the same step on the CPU (IEEE float32 on both), then the same
    step inside a one-rank process group (NCCL on the card) against the
    group-free one (the loss bit for bit; the gradients and parameters
    within the card-vs-CPU limits, and whether they are bit for bit too):
    the path that runs the step's collectives runs on the device."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from githubrepostorag_tpu_torch.device import ieee_float32
    from githubrepostorag_tpu_torch.models.qwen2 import init_params
    from githubrepostorag_tpu_torch.parallel import MeshPlan, make_mesh
    from githubrepostorag_tpu_torch.parallel.sharding import tree_map
    from githubrepostorag_tpu_torch.training.step import leaves

    dev = torch.device(device)
    small = dataclasses.replace(cfg, num_layers=TRAIN_CHECK_LAYERS)
    host = init_params(small, torch.Generator().manual_seed(SEED + 101), "cpu")
    batch = train_batch(small, 2, 64, "cpu", SEED + 102)
    params = tree_map(lambda t: t.to(dev), host)
    dbatch = {k: v.to(dev) for k, v in batch.items()}
    out = {"layers": TRAIN_CHECK_LAYERS, "tokens": 2 * 64}
    t0 = time.monotonic()
    with ieee_float32(dev):
        on_dev = one_step(small, params, dbatch)
    on_cpu = one_step(small, host, batch)
    out["card_vs_cpu"] = compare_steps(on_dev, on_cpu)
    out["card_vs_cpu"]["seconds"] = time.monotonic() - t0
    log(f"train: 2-layer step on {dev.type} against the CPU: {json.dumps(out['card_vs_cpu'])}")

    t0 = time.monotonic()
    saved = one_rank_world(device)
    try:
        mesh = make_mesh(MeshPlan())
        backends = {a: dist.get_backend(g) for a, g in mesh.groups.items()}
        with ieee_float32(dev):
            grouped = one_step(small, params, dbatch, mesh)
        same = torch.equal(grouped[0], on_dev[0])
        out["one_rank_group"] = {
            "backend": dist.get_backend(), "groups": backends, "loss": float(grouped[0]),
            "loss_bit_equal": same,
            "grads_and_params_bit_equal": all(
                torch.equal(x, y) for x, y in zip(leaves(grouped[1]) + leaves(grouped[2]),
                                                  leaves(on_dev[1]) + leaves(on_dev[2]))),
            **compare_steps(grouped, on_dev), "seconds": time.monotonic() - t0}
    finally:
        leave_world(saved)
    log(f"train: the step in a one-rank world: {json.dumps(out['one_rank_group'])}")
    if not same or set(backends) != {"dp", "pp", "tp", "sp", "ep"}:
        raise RuntimeError("the loss inside a one-rank process group differs from the "
                           "group-free step's")
    return out


def train_full(cfg, device, rows: int = 8, seq: int = 512, warmup: int = 2,
               timed: int = 10) -> tuple:
    """``make_train_step`` on ``MeshPlan()`` (remat on) at the model's widths
    and depth, float32 parameters from a seeded generator on ``device``, one
    fixed seeded batch: ``warmup`` then ``timed`` steps (each to a host
    sync).  Returns (the trained params, the numbers)."""
    import torch

    from githubrepostorag_tpu_torch.parallel import MeshPlan, make_mesh
    from githubrepostorag_tpu_torch.training import adamw, init_train_state, make_train_step
    from githubrepostorag_tpu_torch.training.step import leaves

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(SEED + 100)
    mesh = make_mesh(MeshPlan())
    state = init_train_state(cfg, mesh, gen, adamw(1e-4), device=dev)
    params, opt_state = state.params, state.opt_state
    n_params = sum(t.numel() for t in leaves(params))
    batch = train_batch(cfg, rows, seq, dev, SEED + 102)
    step, _ = make_train_step(cfg, mesh, remat=True)
    losses, secs = [], []
    for _ in range(warmup + timed):
        sync(dev)
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))  # a host sync
        secs.append(time.perf_counter() - t0)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"training did not lower a finite loss: {losses}")
    profile = None
    if dev.type == "cuda":  # two more steps, the second traced: device time by kernel
        total, _ = trace_calls(lambda: step(params, opt_state, batch), 1)
        busy = sum(total.values()) / 1e3
        gemm = sum(t for k, t in total.items() if "gemm" in k.lower()) / 1e3
        top = sorted(total.items(), key=lambda kv: -kv[1])[:8]
        profile = {"busy_ms": busy, "gemm_ms": gemm,
                   "top_kernels_ms": {k: t / 1e3 for k, t in top}}
    ms = sorted(s * 1e3 for s in secs[warmup:])
    p50 = ms[len(ms) // 2] if len(ms) % 2 else (ms[len(ms) // 2 - 1] + ms[len(ms) // 2]) / 2
    flops = train_flops(cfg, rows, seq)
    out = {"layers": cfg.num_layers, "params": n_params, "rows": rows, "seq": seq,
           "precision": "float32, IEEE (allow_tf32 off)", "remat": True,
           "losses": losses, "step_ms": ms, "step_ms_p50": p50,
           "first_step_ms": secs[0] * 1e3, "tokens_per_s": rows * seq / (p50 / 1e3),
           "tflop_per_step": flops / 1e12,
           "f32_peak_share": flops / (p50 / 1e3) / PEAK_F32_FLOPS, "profile": profile}
    if dev.type == "cuda":
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del opt_state
    return params, out


def train_checkpoint(params: dict) -> dict:
    """The trained parameters saved with ``save_checkpoint`` into a temp dir
    under _build/, restored onto themselves as the template; every leaf bit
    for bit."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from githubrepostorag_tpu_torch import kernels
    from githubrepostorag_tpu_torch.training import load_checkpoint, save_checkpoint
    from githubrepostorag_tpu_torch.training.step import leaves

    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="train-ckpt-", dir=kernels.BUILD_DIR))
    dev = leaves(params)[0].device
    try:
        nbytes = sum(t.numel() * t.element_size() for t in leaves(params))
        sync(dev)
        t0 = time.monotonic()
        save_checkpoint(str(root / "ckpt"), params)
        save_s = time.monotonic() - t0
        t0 = time.monotonic()
        restored = load_checkpoint(str(root / "ckpt"), template=params)
        sync(dev)
        load_s = time.monotonic() - t0
        exact = all(a.device == b.device and a.dtype == b.dtype and torch.equal(a, b)
                    for a, b in zip(leaves(restored), leaves(params)))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = {"gb": nbytes / 1e9, "save_s": save_s, "save_gb_per_s": nbytes / 1e9 / save_s,
           "load_s": load_s, "load_gb_per_s": nbytes / 1e9 / load_s, "bit_exact": exact}
    if not exact:
        raise RuntimeError("the checkpoint did not restore the parameters bit for bit")
    return out


def phase_train(device: str = "cuda", cfg=None, card: str | None = None, rows: int = 8,
                seq: int = 512) -> dict:
    """Training on the card: Qwen2-0.5B (``cfg``) at its widths and depth in
    float32 through ``make_train_step`` on ``MeshPlan()``, checked against
    the CPU and inside a one-rank NCCL world at 2 layers, its parameters
    round-tripped through a checkpoint."""
    import torch

    from githubrepostorag_tpu_torch.models.qwen2 import Qwen2Config

    t0 = time.monotonic()
    cfg = cfg or Qwen2Config.qwen2_0_5b()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out = {"card": card, "checks": train_checks(cfg, device)}
    params, out["train"] = train_full(cfg, device, rows, seq)
    log(f"train: {json.dumps(out['train'])}")
    out["checkpoint"] = train_checkpoint(params)
    log(f"train: checkpoint {json.dumps(out['checkpoint'])}")
    del params
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out["seconds"] = time.monotonic() - t0
    log(f"train phase: {out['seconds']:.1f} s")
    return out


# ------------------------------------------------------------------ mesh --

MESH_LAYERS = 7  # the mesh phase's bf16 depth in the whole script (28 under --only mesh)
# the float32 ring pages at 7B widths against the chunked path's: within
# RING_PAGE_TOL + RING_PAGE_TOL |ref|.  JAX's CPU tests hold 1e-5 at tiny
# widths; here the chunked path against itself at another chunk width
# parts by 3.4e-5 at layer 1 (two float32 summation orders of the
# 18944-wide MLP), the ring by 3.5e-5, and the ring's pages rounded to
# bf16 (the control each run checks) by far more than the limit
RING_PAGE_TOL = 1e-4
MESH_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")


def unfused_views(cfg, params: dict) -> dict:
    """The tree in the unfused layout a mesh engine takes, each projection
    a view of the fused leaves (no copy)."""
    layers = dict(params["layers"])
    dq, dkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    wqkv, bqkv, wgu = layers.pop("wqkv"), layers.pop("bqkv"), layers.pop("wgu")
    inter = cfg.intermediate_size
    layers.update(wq=wqkv[..., :dq], wk=wqkv[..., dq:dq + dkv], wv=wqkv[..., dq + dkv:],
                  bq=bqkv[..., :dq], bk=bqkv[..., dq:dq + dkv], bv=bqkv[..., dq + dkv:],
                  wg=wgu[..., :inter], wu=wgu[..., inter:])
    return {**params, "layers": layers}


def mesh_kernel_cases(rng) -> dict:
    """Every kernel at the shapes one tp rank launches at Qwen2-7B's widths,
    against its plain version, timed (bf16) with its bound and library time:
    A and B at 14/2 (tp 2) and 7/1 (tp 4) heads, fp and int8 pages; C at
    7/1; E and D on a tp 4 rank's slices of wgu and wd, group 64."""
    import torch

    dev = torch.device("cuda")
    out, checks = {}, []

    def keep(key, res):
        checks.append((key, res))
        log(f"mesh kernel {key}: {json.dumps(res)}")
        out[key] = {k: res[k] for k in MESH_KEYS + ("limit_share",) if k in res}
        if "plan" in res:
            out[key]["plan"] = res["plan"]

    for tp, (n_q, n_kv) in ((2, (14, 2)), (4, (7, 1))):
        a = kernel_a_case(rng, dev, 4, 512, n_q, n_kv, 128, 128, cached=[0, 1024, 2560, 3584],
                          new=[512, 512, 300, 512])
        keep(f"fused_window_attention@tp{tp}", measure_kernel_a(a, True))
        keep(f"fused_window_attention@int8@tp{tp}", measure_kernel_a(quantized_case(a, 8), True))
        del a
        pool = rng.integers(1, 8193, size=8)
        pool[0] = 8192
        b = kernel_b_case(rng, dev, 8, n_q, n_kv, 128, 128, pool.tolist(), n_steps=8,
                          staged_len=8)
        keep(f"paged_attention_decode_staged@tp{tp}", measure_kernel_b(b, True))
        b = quantized_case(dict(b, k=b["k"][-1:], v=b["v"][-1:], layer=0), 8, n_layers=28)
        keep(f"paged_attention_decode_staged@int8@tp{tp}", measure_kernel_b(b, True))
        del b
        torch.cuda.empty_cache()
    c = kernel_c_case(rng, dev, 7, 1, 128, 128, cached=[0, 1024, 2500, 0, 3000],
                      new=[512, 512, 300, 500, 100], tq=512, budget=2048, dtype=torch.bfloat16)
    keep("packed_prefill_attention_seg@tp4", measure_kernel_c(c, True))
    del c
    gen = torch.Generator(device="cuda")
    gen.manual_seed(int(rng.integers(1 << 30)))
    for name, (k, n) in (("wgu", (3584, 37888 // 4)), ("wd", (18944 // 4, 3584))):
        w, _ = int4_case(gen, k, n)
        x = torch.randn((8, k), generator=gen, device="cuda").bfloat16()
        keep(f"w4a8_matmul@{name}@tp4", measure_w4a8(x, w, w, torch.bfloat16, True))
        x = torch.randn((4096, k), generator=gen, device="cuda").bfloat16()
        keep(f"int4_matmul@{name}@tp4", measure_int4(x, w, w, torch.bfloat16, True))
        del w, x
        torch.cuda.empty_cache()
    bad = [key for key, r in checks if not r["limit_share"] <= 1.0]
    if bad:
        raise RuntimeError(f"rank-shard kernels disagree with their plain versions: {bad}")
    return out


def one_rank_world(device: str = "cuda"):
    """Join a one-rank world from a localhost JAX_COORDINATOR_ADDRESS (NCCL
    on the card); returns the environment to restore."""
    import os
    import socket

    from githubrepostorag_tpu_torch.parallel import maybe_initialize_distributed

    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    env = {"JAX_COORDINATOR_ADDRESS": f"localhost:{port}", "JAX_NUM_PROCESSES": "1",
           "JAX_PROCESS_ID": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    if not maybe_initialize_distributed(device=device):
        raise RuntimeError("maybe_initialize_distributed did not start the world")
    return saved


def leave_world(saved: dict) -> None:
    import os

    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


@contextlib.contextmanager
def counting_collectives():
    """Counts of ``torch.distributed.all_reduce`` and ``all_gather`` calls
    (the collectives ``parallel/collectives.py`` issues) while the block
    runs."""
    import torch.distributed as dist

    counts = {"all_reduce": 0, "all_gather": 0}
    saved = {name: getattr(dist, name) for name in counts}

    def counted(name):
        def call(*args, **kwargs):
            counts[name] += 1
            return saved[name](*args, **kwargs)
        return call

    for name in counts:
        setattr(dist, name, counted(name))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


@contextlib.contextmanager
def tp_collectives_at_tp1():
    """While the block runs, the model issues its tp collectives on a tp
    group of one rank too (``models/qwen2._tp_group`` / ``_tp_split``
    swapped for the rule a tp slice takes), so a one-rank world carries
    them over its backend; the serving path issues none at tp 1, as JAX's
    GSPMD inserts none."""
    from githubrepostorag_tpu_torch.models import qwen2

    saved = qwen2._tp_group, qwen2._tp_split
    qwen2._tp_group = lambda mesh: mesh.group("tp") if mesh is not None else None
    qwen2._tp_split = lambda mesh, local, full: qwen2._tp_group(mesh) is not None
    try:
        yield
    finally:
        qwen2._tp_group, qwen2._tp_split = saved


def collective_host_us(mesh, device: str = "cuda", n: int = 200) -> dict:
    """Host µs a call of each tp collective on the one-rank world's tp
    group, over a decode step's [8, 3584] bf16 rows, idle and after ten
    matmuls of queued device work each (the device drains at the end)."""
    import torch
    import torch.distributed as dist

    from githubrepostorag_tpu_torch.parallel.collectives import gather_from_axis, reduce_from_axis

    group = mesh.group("tp")
    x = torch.randn(8, 3584, dtype=torch.bfloat16, device=device)
    w = torch.randn(3584, 3584, dtype=torch.bfloat16, device=device)
    calls = {"all_reduce": lambda: dist.all_reduce(x, group=group),
             "reduce_from_axis": lambda: reduce_from_axis(x, group),
             "gather_from_axis": lambda: gather_from_axis(x, group)}
    out = {}
    for name, fn in calls.items():
        for busy in (False, True):
            def step():
                if busy:
                    for _ in range(10):
                        x @ w
                fn()
            for _ in range(10):
                step()
            sync(device)
            t0 = time.perf_counter()
            for _ in range(n):
                step()
            out[name + ("_busy" if busy else "")] = (time.perf_counter() - t0) / n * 1e6
            sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        for _ in range(10):
            x @ w
    out["ten_matmuls"] = (time.perf_counter() - t0) / n * 1e6
    sync(device)
    return out


def mesh_engine_runs(cfg, params, mesh, layers: int, device: str = "cuda") -> dict:
    """The mesh path against the mesh-less engine: float32 at 2 layers (every
    greedy token equal, with every tp collective of the path issued through
    the world's backend at size 1, ``tp_collectives_at_tp1``), then bf16
    at ``layers``: TTFT and TPOT p50 of the same traffic through each, in
    turns (mesh-less, mesh, mesh with the size-1 tp collectives, packed and
    int4 on the mesh, mesh, mesh-less), each run's kernels pinned."""
    import torch

    from githubrepostorag_tpu_torch.models.quant import quantize_qwen2_params
    from githubrepostorag_tpu_torch.serving.engine import Engine
    from githubrepostorag_tpu_torch.serving.sampling_params import SamplingParams

    rng = np.random.default_rng(SEED + 181)
    geometry = dict(max_num_seqs=8, num_pages=320, page_size=128, max_seq_len=4096,
                    prefill_chunk=512, decode_burst=8, device=device)
    out = {}
    c2, p2 = at_depth(cfg, params, 2)
    p32 = upcast(p2)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (300, 700, 1100, 64)]
    sp = SamplingParams(max_tokens=16, temperature=0.0, stop_token_ids=())
    want = [r.output_tokens for r in Engine(p32, c2, kv_dtype=torch.float32, **geometry)
            .generate(prompts, sp)]
    with tp_collectives_at_tp1(), counting_collectives() as issued:
        got = [r.output_tokens for r in Engine(unfused_views(c2, p32), c2, mesh=mesh,
                                               kv_dtype=torch.float32, **geometry)
               .generate(prompts, sp)]
    out["f32_2_layers"] = {"tokens": sum(map(len, got)), "equal": got == want,
                           "collectives": dict(issued)}
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    if got != want:
        raise RuntimeError("the one-rank mesh engine's float32 tokens differ from the "
                           "mesh-less engine's")
    if not all(issued.values()):
        raise RuntimeError(f"the one-rank mesh engine issued {dict(issued)}: the tp "
                           "collectives of the path (the embedding's and the row-parallel "
                           "sums, the logits' gather) must reach the world's backend")

    cq, pq = at_depth(cfg, params, layers)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(600, 1400, size=10)]
    prompts, warm = prompts[:8], prompts[8:]
    sp = SamplingParams(max_tokens=48, temperature=0.0, stop_token_ids=())
    unfused = unfused_views(cq, pq)
    a, b, c = ("fused_window_attention", "paged_attention_decode_staged",
               "packed_prefill_attention_seg")
    runs = (("meshless", lambda: Engine(pq, cq, **geometry), (a, b)),
            ("mesh", lambda: Engine(unfused, cq, mesh=mesh, **geometry), (a, b)),
            # the same with the tp collectives a tp slice issues, at size 1
            ("mesh_tp1_collectives", lambda: Engine(unfused, cq, mesh=mesh, **geometry), (a, b)),
            # the packed and int4 paths on the mesh: C; D and E on the slices
            ("mesh_packed", lambda: Engine(unfused, cq, mesh=mesh, prefill_token_budget=2048,
                                           **geometry), (c, b)),
            ("mesh_int4", lambda: Engine(quantize_qwen2_params(unfused, bits=4, group_size=GROUP),
                                         cq, mesh=mesh, **geometry),
             (a, b, "int4_matmul", "w4a8_matmul")),
            # in turns: mesh-less, mesh, ..., mesh, mesh-less
            ("mesh_2", lambda: Engine(unfused, cq, mesh=mesh, **geometry), (a, b)),
            ("meshless_2", lambda: Engine(pq, cq, **geometry), (a, b)))
    for label, build, required in runs:
        collectives = (tp_collectives_at_tp1() if label == "mesh_tp1_collectives"
                       else contextlib.nullcontext())
        with collectives:
            eng = build()
            eng.generate(warm, sp)  # kernel plans, cuBLAS handles
            sync(device)
            reset_launches()
            t0 = time.monotonic()
            res = eng.generate(prompts, sp)
            sync(device)
        launches = read_launches()
        ttft = [r.ttft_s * 1e3 for r in res]
        tpot = [r.decode_time_s * 1e3 / (len(r.output_tokens) - 1) for r in res]
        out[label] = {"layers": layers, "requests": len(res), "wall_s": time.monotonic() - t0,
                      "ttft_ms_p50": percentile(ttft, 50), "tpot_ms_p50": percentile(tpot, 50),
                      "launches": {k: launches[k] for k in launch_counters()}}
        log(f"mesh engine {label}: {json.dumps(out[label])}")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        if device == "cuda" and not all(out[label]["launches"][k] for k in required):
            raise RuntimeError(f"the {label} run launched {out[label]['launches']}: "
                               f"{required} must launch")
    return out


def chunked_prefill(params, cfg, prompts, k_pages, v_pages, bt, chunk: int = 512):
    """The chunked path's prefill of ``prompts`` (every row's next chunk in
    one forward_paged call: kernel A) into the pools at block tables ``bt``;
    returns each row's first-token logits [R, V]."""
    import torch

    from githubrepostorag_tpu_torch.models.qwen2 import forward_paged
    from githubrepostorag_tpu_torch.serving.kv_cache import slot_mapping

    dev = k_pages.device
    r, logits = len(prompts), [None] * len(prompts)
    for start in range(0, max(map(len, prompts)), chunk):
        ids = np.zeros((r, chunk), dtype=np.int32)
        pos = np.zeros((r, chunk), dtype=np.int32)
        slots = np.full((r, chunk), -1, dtype=np.int32)
        new = np.zeros((r,), dtype=np.int32)
        for i, p in enumerate(prompts):
            n = max(0, min(chunk, len(p) - start))
            ids[i, :n] = p[start:start + n]
            pos[i] = np.arange(start, start + chunk)
            slots[i] = slot_mapping(bt[i], start, n, k_pages.shape[3], chunk)
            new[i] = n
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        last = t(np.maximum(new - 1, 0))
        out = forward_paged(params, cfg, t(ids), t(pos), k_pages, v_pages, t(slots),
                            t(bt.astype(np.int32)), t(np.full((r,), start, dtype=np.int32)),
                            t(new), logits_at=last)[0]
        for i, p in enumerate(prompts):
            if start < len(p) <= start + chunk:
                logits[i] = out[i, 0]
    return torch.stack(logits)


def ring_vs_chunked(cfg, params, mesh, layers: int, device: str = "cuda") -> dict:
    """The ring prefill at sp = 1 against chunked prefill: prompts of 3000
    and 1000 tokens in one 4096-token packed pass and the 3000 alone in a
    one-sequence pass; float32 at 2 layers: first tokens equal, and pages
    within ``RING_PAGE_TOL`` + ``RING_PAGE_TOL`` |ref| of the chunked
    path's, a limit the same pages rounded to bf16 must fail (the control);
    the chunked path at 1024-token chunks and JAX's 1e-5 + 1e-5 |ref| are
    logged beside it.  bf16 at ``layers``: the ring pass's ms beside
    chunked prefill's for the same tokens, then 32 decode tokens a row
    through kernel B over the ring-written pages."""
    import torch

    from githubrepostorag_tpu_torch.ops.packed_prefill import ring_segment_layout
    from githubrepostorag_tpu_torch.ops.paged_decode import paged_attention_decode_staged
    from githubrepostorag_tpu_torch.serving.decode_burst import decode_burst
    from githubrepostorag_tpu_torch.serving.kv_cache import (
        make_page_pools, packed_slot_mapping, slot_mapping)
    from githubrepostorag_tpu_torch.serving.long_prefill import ring_prefill, ring_prefill_packed

    rng = np.random.default_rng(SEED + 182)
    dev = torch.device(device)
    ps, width, lens = 128, 4096, (3000, 1000)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    need = [-(-n // ps) + 1 for n in lens]  # a page of room for decode
    bt = np.zeros((2, 33), dtype=np.int32)
    bt[0, :need[0]] = np.arange(need[0])
    bt[1, :need[1]] = np.arange(need[0], need[0] + need[1])
    num_pages = sum(need)
    seg, pos, logits_at, starts = ring_segment_layout(list(lens), width, 2)
    ids = np.zeros((1, width), dtype=np.int32)
    slots = np.full((width,), -1, dtype=np.int32)
    for i, (p, off) in enumerate(zip(prompts, starts)):
        ids[0, off:off + len(p)] = p
        packed_slot_mapping(bt[i], 0, len(p), ps, slots, int(off))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    one_ids = np.zeros((1, width), dtype=np.int32)
    one_ids[0, :lens[0]] = prompts[0]
    one_slots = slot_mapping(bt[0], 0, lens[0], ps, width)[None]

    def pools(c, dtype):
        pp = make_page_pools(c, num_pages, ps, dtype=dtype, device=dev)
        return pp.k, pp.v

    def packed(p, c, kp, vp):
        return ring_prefill_packed(p, c, t(ids), t(pos[None]), kp, vp, t(slots[None]),
                                   t(seg[None]), t(logits_at), mesh)[0][:, 0]

    out = {}
    c2, p2 = at_depth(cfg, params, 2)
    p32 = unfused_views(c2, upcast(p2))
    kc, vc = pools(c2, torch.float32)
    first = chunked_prefill(p32, c2, prompts, kc, vc, bt).argmax(-1)
    # the chunked path against itself at another chunk width (GEMMs of
    # other row counts): float32's own spread between two summation orders
    kw, vw = pools(c2, torch.float32)
    wide_first = chunked_prefill(p32, c2, prompts, kw, vw, bt, chunk=1024).argmax(-1)
    kr, vr = pools(c2, torch.float32)
    ring_first = packed(p32, c2, kr, vr).argmax(-1)
    k1, v1 = pools(c2, torch.float32)
    one = ring_prefill(p32, c2, t(one_ids), t(np.arange(width, dtype=np.int32)[None]), k1, v1,
                       t(one_slots), t(np.asarray([lens[0] - 1], dtype=np.int32)), mesh)[0]

    def diffs(k, v, pages):
        """Per layer: max |pages - chunked pages|, and the share of the
        limit ``RING_PAGE_TOL`` (1 + |ref|) and of JAX's 1e-5 (1 + |ref|)
        the worst element uses."""
        out = []
        for li in range(c2.num_layers):
            d, share = 0.0, 0.0
            for a, b in ((k, kc), (v, vc)):
                e = (a[li, :, pages].float() - b[li, :, pages]).abs()
                d = max(d, e.max().item())
                share = max(share, (e / (1 + b[li, :, pages].abs())).max().item())
            out.append({"max_diff": d, "limit_share": share / RING_PAGE_TOL,
                        "jax_limit_share": share / 1e-5})
        return out

    real, row0 = slice(0, num_pages), slice(0, need[0])
    res = {"first_tokens": first.tolist(), "ring_first_tokens": ring_first.tolist(),
           "chunk1024_first_tokens": wide_first.tolist(),
           "one_seq_first_token": int(one[0, 0].argmax()),
           "ring": diffs(kr, vr, real), "one_seq": diffs(k1, v1, row0),
           "chunk1024": diffs(kw, vw, real),
           "control_bf16_ring": diffs(kr.to(torch.bfloat16), vr.to(torch.bfloat16), real)}
    out["f32_2_layers"] = res
    log(f"mesh ring vs chunked f32: {json.dumps(res)}")

    def near(rows):
        return all(r["limit_share"] <= 1.0 for r in rows)

    if near(res["control_bf16_ring"]):
        raise RuntimeError("the ring's page limit passes bf16-rounded pages: it cannot tell "
                           "a float32 commit from a bf16 one")
    if (ring_first.tolist() != first.tolist() or wide_first.tolist() != first.tolist()
            or int(one[0, 0].argmax()) != int(first[0]) or not near(res["ring"])
            or not near(res["one_seq"])):
        raise RuntimeError("the ring prefill at sp = 1 disagrees with the chunked path")
    del p32, kc, vc, kw, vw, kr, vr, k1, v1
    gc.collect()
    torch.cuda.empty_cache()

    cq, pq = at_depth(cfg, params, layers)
    pu = unfused_views(cq, pq)
    kp, vp = pools(cq, torch.bfloat16)
    kc, vc = pools(cq, torch.bfloat16)
    packed(pu, cq, kp, vp)  # warm
    chunked_prefill(pu, cq, prompts, kc, vc, bt)
    ring_ms = time_ms(lambda: packed(pu, cq, kp, vp), 3, warmup=0) if dev.type == "cuda" else 0
    chunk_ms = (time_ms(lambda: chunked_prefill(pu, cq, prompts, kc, vc, bt), 3, warmup=0)
                if dev.type == "cuda" else 0)
    first = packed(pu, cq, kp, vp).argmax(-1).to(torch.int32)
    b = 2
    vocab = cq.vocab_size
    presence = torch.zeros((b, vocab + 1), dtype=torch.bool, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    ones, zeros = torch.ones(b, device=dev), torch.zeros(b, dtype=torch.int32, device=dev)
    last, lens_d = first, t(np.asarray(lens, dtype=np.int32))
    limits = t((np.asarray(need) * ps - 1).astype(np.int32))
    bt_d = t(bt)
    active = torch.ones(b, dtype=torch.bool, device=dev)
    before = paged_attention_decode_staged.launches
    decoded = []
    for _ in range(4):  # four bursts of 8, as the engine's default
        toks, _, _, _, presence, lens_d = decode_burst(
            pu, cq, last, lens_d, kp, vp, presence, active, limits, bt_d, gen, ones * 0.0,
            ones, zeros, ones, n_steps=8, filter_sampling=False, mesh=mesh)
        decoded.append(toks)
        last = toks[:, -1]
    decoded = torch.cat(decoded, dim=1)
    sync(dev)
    b_launches = paged_attention_decode_staged.launches - before
    out["bf16"] = {"layers": layers, "tokens": sum(lens), "ring_ms": ring_ms,
                   "chunked_ms": chunk_ms, "decode_tokens_per_row": decoded.shape[1],
                   "decode_b_launches": b_launches}
    log(f"mesh ring vs chunked bf16: {json.dumps(out['bf16'])}")
    if (decoded.shape[1] != 32 or not bool(((decoded >= 0) & (decoded < vocab)).all())
            or b_launches != (32 * layers if dev.type == "cuda" else 0)):
        raise RuntimeError(f"decode over the ring-written pages: {decoded.shape[1]} tokens, "
                           f"{b_launches} kernel B launches")
    return out


def phase_mesh(cfg, params, layers: int = MESH_LAYERS) -> dict:
    """Serving over a tp / sp / ep mesh, as one rank sees it on the card
    (the module docstring's ``mesh`` entry)."""
    import torch

    from githubrepostorag_tpu_torch.parallel import MeshPlan, make_mesh

    t0 = time.monotonic()
    release_planes()  # earlier phases' engines stay registered, and on the card
    gc.collect()
    torch.cuda.empty_cache()
    out = {"kernels": mesh_kernel_cases(np.random.default_rng(SEED + 180))}
    log(f"mesh: rank-shard kernels in {time.monotonic() - t0:.1f} s")
    saved = one_rank_world()
    try:
        import torch.distributed as dist

        mesh = make_mesh(MeshPlan())
        out["world"] = {"backend": dist.get_backend(), "groups": sorted(mesh.groups)}
        out["collective_host_us"] = collective_host_us(mesh)
        log(f"mesh: size-1 tp collectives, host us a call: "
            f"{json.dumps(out['collective_host_us'])}")
        out["engine"] = mesh_engine_runs(cfg, params, mesh, layers)
        out["ring"] = ring_vs_chunked(cfg, params, mesh, layers)
    finally:
        leave_world(saved)
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.monotonic() - t0
    log(f"mesh phase: {out['seconds']:.1f} s")
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", choices=["kernels", "longctx", "int4", "retrieval", "rag",
                                           "ingest", "options", "split", "modes", "draft",
                                           "fleet", "moe", "train", "mesh"],
                        default=None,
                        help="kernels: the device, build and kernel phases only; longctx: "
                             "the device and build phases and the long-context decode "
                             "profiles only; int4: the device and build phases, kernel E's "
                             "route times, and the int4-weight engine run and its profile; "
                             "retrieval: the device and retrieval phases only; rag: the "
                             "device and build phases and the question-answering loop (its "
                             "index built at the retrieval phase's size); ingest: the device "
                             "and build phases and the ingest phase; options: the device and "
                             "build phases and the engine options measured in pairs "
                             "(long-context profiles, rag jobs); split: the device and build "
                             "phases, the rag phase and the split deployment (API pod, "
                             "Redis, Cassandra, the worker pod, the native store); modes: "
                             "the device and build phases, kernel A at the verify window "
                             "and the engine modes phase; draft: the device and build "
                             "phases, kernel A at the draft's and the verify rungs' shapes "
                             "and the draft-model speculation phase; fleet: the device and "
                             "build phases and the fleet phase (router over dp:2, the "
                             "disaggregated handoff, the controller's failover); moe: the "
                             "device and build phases and the Qwen2-MoE phase (A and B at "
                             "group 1, float32 checks, the A2.7B served at 24 layers, an MoE "
                             "checkpoint over HTTP); train: the device phase and the training "
                             "phase (Qwen2-0.5B in float32, its checks and its checkpoint); "
                             "mesh: the device and build phases and the mesh phase (the "
                             "kernels at a tp rank's shapes, a one-rank NCCL world through "
                             "the mesh engine at 28 layers, the ring prefill at sp 1)")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    try:
        import githubrepostorag_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: run from the repository root ({exc})", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_all = time.monotonic()
    device = phase_device()
    packages = package_presence()
    if args.only == "retrieval":
        retrieval = phase_retrieval()
        log(f"done in {time.monotonic() - t_all:.1f} s")
        print(json.dumps({"packages": packages}))
        print(json.dumps({"retrieval": retrieval}), flush=True)
        return 0
    if args.only == "train":
        train = phase_train(card=device["card"])
        log(f"done in {time.monotonic() - t_all:.1f} s")
        print(json.dumps({"train": train}))
        print(device["card"])
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device["kind"],
                                                 "count": device["count"]}}), flush=True)
        return 0
    phase_build()
    if args.only == "rag":
        cfg, params = make_7b_params()
        rag = phase_rag(cfg, params)
        log(f"done in {time.monotonic() - t_all:.1f} s")
        print(json.dumps({"packages": packages}))
        print(device["card"])
        print(json.dumps({"rag": rag}), flush=True)
        return 0
    if args.only == "split":
        cfg, params = make_7b_params()
        t0 = time.monotonic()
        index, enc, passages = rag_index("cuda")
        log(f"rag index built in {time.monotonic() - t0:.1f} s")
        rag, split = rag_and_split(cfg, params, index, enc, passages)
        log(f"done in {time.monotonic() - t_all:.1f} s")
        print(json.dumps({"rag": rag}))
        print(json.dumps({"split": split}))
        print(device["card"])
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device["kind"],
                                                 "count": device["count"]}}), flush=True)
        return 0
    if args.only == "modes":
        checks = []
        def check(label, res):
            checks.append((label, res))
            log(f"{label}: {json.dumps(res)}")
            return res

        verify = verify_window_cases(np.random.default_rng(SEED), torch.device("cuda"), check)
        if any(r["limit_share"] > 1.0 for _, r in checks):
            raise RuntimeError("kernel A disagrees with its plain version at the verify window")
        cfg, params = make_7b_params()
        modes = phase_modes(cfg, params)
        log(f"done in {time.monotonic() - t_all:.1f} s")
        print(json.dumps({"kernel_a_verify_window": verify}))
        print(json.dumps({"modes": modes}))
        print(device["card"])
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device["kind"],
                                                 "count": device["count"]}}), flush=True)
        return 0
    if args.only == "draft":
        checks = []

        def check(label, res):
            checks.append((label, res))
            log(f"{label}: {json.dumps(res)}")
            return res

        shapes = draft_window_cases(np.random.default_rng(SEED), torch.device("cuda"), check)
        if any(r["limit_share"] > 1.0 for _, r in checks):
            raise RuntimeError("kernel A disagrees with its plain version at the draft's shapes")
        cfg, params = make_7b_params()
        draft = phase_draft(cfg, params)
        log(f"done in {time.monotonic() - t_all:.1f} s")
        print(json.dumps({"kernel_a_draft_shapes": shapes}))
        print(json.dumps({"draft": draft}))
        print(device["card"])
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device["kind"],
                                                 "count": device["count"]}}), flush=True)
        return 0
    if args.only == "mesh":
        cfg, params = make_7b_params()
        mesh = phase_mesh(cfg, params, layers=cfg.num_layers)
        log(f"done in {time.monotonic() - t_all:.1f} s")
        print(json.dumps({"mesh": mesh}))
        print(device["card"])
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device["kind"],
                                                 "count": device["count"]}}), flush=True)
        return 0
    if args.only == "fleet":
        cfg, params = make_7b_params()
        fleet = phase_fleet(cfg, params)
        log(f"done in {time.monotonic() - t_all:.1f} s")
        print(json.dumps({"fleet": fleet}))
        print(device["card"])
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device["kind"],
                                                 "count": device["count"]}}), flush=True)
        return 0
    if args.only == "moe":
        moe = phase_moe()
        log(f"done in {time.monotonic() - t_all:.1f} s")
        print(json.dumps({"moe": moe}))
        print(device["card"])
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device["kind"],
                                                 "count": device["count"]}}), flush=True)
        return 0
    if args.only == "ingest":
        cfg, params = make_7b_params()
        ingest = phase_ingest(cfg, params)
        log(f"done in {time.monotonic() - t_all:.1f} s")
        print(device["card"])
        print(json.dumps({"ingest": ingest}), flush=True)
        return 0
    if args.only == "options":
        cfg, params = make_7b_params()
        t0 = time.monotonic()
        index, enc, _ = rag_index("cuda")
        log(f"rag index built in {time.monotonic() - t0:.1f} s")
        options = phase_options(cfg, params, index, enc)
        log(f"done in {time.monotonic() - t_all:.1f} s")
        print(device["card"])
        print(json.dumps({"options": options}), flush=True)
        return 0
    if args.only == "longctx":
        cfg, params = make_7b_params()
        for label, kw in (("bf16", {}), ("kv int8", {"kv_quant": 8})):
            log(f"longctx {label}: {json.dumps(phase_longctx(cfg, params, label, **kw))}")
        log(f"done in {time.monotonic() - t_all:.1f} s")
        return 0
    if args.only == "int4":
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED + 5)
        w4a8_route_times(gen)
        cfg, params = make_7b_params()
        qparams = quantize_7b(params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        run = phase_int4_engine(cfg, qparams, earlier_port=True)
        log(f"int4 engine: {json.dumps(run)}")
        log(f"done in {time.monotonic() - t_all:.1f} s")
        return 0
    kres = {**phase_kernels(), **phase_int4_kernels(np.random.default_rng(SEED + 3))}
    dispatch = phase_dispatcher()
    if args.only == "kernels":
        log(f"done in {time.monotonic() - t_all:.1f} s")
        return 0
    store = {}  # the retrieval phase's index and encoder, for the rag phase
    retrieval = phase_retrieval(keep=store)
    gc.collect()
    torch.cuda.empty_cache()
    phase_load()
    cfg, params = make_7b_params()
    p32 = upcast(params)
    phase_model(cfg, params, "7B bf16", p32)
    phase_packed_model(cfg, params, p32)
    phase_quant_pools_model(cfg, p32)
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    a, b, c = "fused_window_attention", "paged_attention_decode_staged", "packed_prefill_attention_seg"
    enc = store.pop("encoder")
    runs = {"bf16": phase_engine(cfg, params, "bf16", (a, b), (c,), tail=True)}
    # the same traffic with the width ladder and prefill priority on
    runs["options"] = phase_engine(cfg, params, "bf16 prefill_widths=3 prefill_priority",
                                   (a, b, a + "@S512", a + "@S256", a + "@S128"), (c,),
                                   profile=False, tail=True, prefill_widths=3,
                                   prefill_priority=True)
    options = check_options_run(runs["bf16"], runs["options"])
    # cuBLAS's rows by GEMM row count: the engine's prefill row floor needs
    # none to differ from 512 rows on (checked in the kernel phase)
    options["gemm_rows_differing_by_m"] = kres["gemm_rows"]
    runs["http"] = phase_http(cfg, params)
    runs["rag"], runs["split"] = rag_and_split(cfg, params, store.pop("index"), enc)
    # the ingest, modes, draft and fleet phases at a quarter of the depth
    # here, at the published widths, so the whole script ends well inside
    # its time limit on a slow host; their --only runs keep all 28 layers
    cfg_q, params_q = at_depth(cfg, params, cfg.num_layers // 4)
    runs.update({
        "ingest": {"layers": cfg_q.num_layers, **phase_ingest(cfg_q, params_q, enc=enc)},
        # packed prefill over bf16 pools never reaches kernel A
        "packed": phase_engine(cfg, params, "packed bf16", (c, b), (a,),
                               prefill_token_budget=2048),
        "kv8": phase_engine(cfg, params, "kv int8", (a + "@int8", b + "@int8"), (c,),
                            profile=False, kv_quant=8),
        # int4 pages decode on the gather path, so kernel B never launches
        "kv4": phase_engine(cfg, params, "kv int4 packed", (a + "@int4",), (b, c),
                            profile=False, kv_quant=4, prefill_token_budget=2048),
    })
    gc.collect()
    torch.cuda.empty_cache()
    longctx = {"bf16": phase_longctx(cfg, params, "bf16"),
               "kv8": phase_longctx(cfg, params, "kv int8", kv_quant=8)}
    log(f"long-context decode profiles: {json.dumps(longctx)}")
    modes = {"layers": cfg_q.num_layers, **phase_modes(cfg_q, params_q)}
    gc.collect()
    torch.cuda.empty_cache()
    draft = {"layers": cfg_q.num_layers, **phase_draft(cfg_q, params_q)}
    gc.collect()
    torch.cuda.empty_cache()
    fleet = {"layers": cfg_q.num_layers, **phase_fleet(cfg_q, params_q)}
    del params_q
    gc.collect()
    torch.cuda.empty_cache()
    mesh = phase_mesh(cfg, params)
    qparams = quantize_7b(params)
    del params  # the bf16 tree and engines are gone before the int4 phases
    gc.collect()
    torch.cuda.empty_cache()
    phase_model(cfg, qparams, "7B int4")
    phase_decode_logits(cfg, qparams)
    runs["int4"] = phase_int4_engine(cfg, qparams)
    del qparams  # one model's weights at a time: the MoE tree alone from here
    gc.collect()
    torch.cuda.empty_cache()
    moe = phase_moe(MOE_DEFAULT_LAYERS, kernels={k: r for k, r in kres.items()
                                                 if k.endswith("@g1")})
    release_planes()
    train = phase_train(card=device["card"])

    # each kernel's (and branch's) launches come from the run whose path it
    # belongs to; A and B carry their pool branches
    runs["dispatch"] = dispatch
    launch_run = {a: "bf16", b: "bf16", c: "packed", "int4_matmul": "int4",
                  "w4a8_matmul": "int4", "paged_attention_decode": "dispatch",
                  a + "@int8": "kv8", a + "@int4": "kv4", b + "@int8": "kv8"}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

    def numbers(key):
        return {"launches": runs[launch_run[key]]["launches"][key],
                **{k: kres[key][k] for k in keys}}

    from githubrepostorag_tpu_torch.ops.paged_decode import _plan_decode

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    entries = []
    for name, (source, replaces) in SOURCES.items():
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 **numbers(name)}
        if name == "int4_matmul":
            entry["launches_by_loader"] = {
                k: runs["int4"]["launches"][f"{name}@{k}"] for k in ("tma", "cp_async", "f32")}
        if name == "w4a8_matmul":  # the whole route; every decode shape timed
            entry["launches_by_kernel"] = {
                k: runs["int4"]["launches"][f"{name}@{k}"] for k in ("mma", "dp4a")}
            entry["host_us"] = kres[name]["host_us"]
            entry["shapes"] = {
                key.split("@", 1)[1]: {k: r[k] for k in keys + ("bound_share", "events_ms",
                                                                "prologue_us", "host_us")}
                for key, r in kres.items() if key.startswith(name + "@")}
        if name in (a, c):  # the launch plan of the timed case; the wrapper's host time
            entry["plan"] = kres[name]["plan"]
            entry["host_us"] = kres[name]["host_us"]
        if name == a:
            # the width ladder's S = 256 window, alone; the options run's
            # launches by window
            entry["window_256"] = {pool: {k: kres[key][k] for k in keys + ("host_us",)}
                                   for pool, key in (("fp", a + "@S256"),
                                                     ("int8", a + "@int8@S256"))}
            entry["launches_by_window_options_run"] = options["a_launches_by_window"]
            # the long-context profile's launch, alone and in the profile
            entry["long_context"] = {
                pool: {"launches": longctx[run]["kernel_a_launches"],
                       "profile_ms": longctx[run]["kernel_a_ms"],
                       **{k: kres[key][k] for k in keys + ("host_us",)}}
                for pool, run, key in (("fp", "bf16", a + "@longctx"),
                                       ("int8", "kv8", a + "@int8@longctx"),
                                       ("fp_window512", "bf16", a + "@longctx512"))}
            # the speculative verify window (S = k+1 = 5), alone, and its
            # launches per committed token in the modes runs
            entry["verify_window"] = {pool: {k: kres[key][k] for k in keys + ("host_us",)}
                                      for pool, key in (("fp", a + "@S5"),
                                                        ("int8", a + "@int8@S5"),
                                                        ("int4", a + "@int4@S5"))}
            entry["verify_window"]["launches_per_token"] = {
                run: modes["runs"][run]["a_launches_per_token"]
                for run in ("default", "spec", "burst", "fused", "fused_int4")}
            # the draft-model path's shapes, alone, and the draft runs'
            # launches per committed token by head dim and window
            entry["draft_shapes"] = {key.split("@", 1)[1]: {k: kres[key][k]
                                                            for k in keys + ("host_us",)}
                                     for key in kres if key.startswith(a + "@draft_")
                                     or key in (a + "@S2", a + "@S3")}
            entry["draft_shapes"]["launches_per_token"] = {
                run: {"all": draft["runs"][run]["a_launches_per_token"],
                      **draft["runs"][run]["a_launches_by_head_dim"],
                      "by_window": draft["runs"][run]["a_launches_by_window"]}
                for run in ("random", "random_floor0", "quoting", "partial")}
        if name in (a, b):  # the Qwen2-MoE path's group-1 shapes, alone; its launches
            entry["moe_group1"] = {
                key.split("@")[1] if key.count("@") > 1 else "fp":
                    {k: r[k] for k in keys + ("host_us",)}
                for key, r in moe["kernels"].items() if key.split("@")[0] == name}
            entry["launches_moe_path"] = moe["serve"]["launches"][name]
        if name in (a, b, c, "int4_matmul", "w4a8_matmul"):
            # one tp rank's shapes (the mesh phase), and launches on the
            # one-rank mesh engine's run (its bf16 path runs A and B only)
            entry["rank_shard"] = {key.split("@", 1)[1]: r for key, r in mesh["kernels"].items()
                                   if key.split("@")[0] == name}
            entry["launches_mesh_path"] = {
                run: mesh["engine"][run]["launches"][name]
                for run in ("mesh", "mesh_packed", "mesh_int4")}
        if name in ("paged_attention_decode_staged", "paged_attention_decode"):
            # the split of the timed cases: 4 kv heads, 64 pages of 128 keys
            entry["plan"] = {f"B={bb}": _plan_decode(bb, 4, 64, 128, n_sm)._asdict()
                             for bb in (1, 8, 64)}
        branches = [k for k in launch_run if k.startswith(name + "@")]
        if branches:
            entry["branches"] = {"fp": numbers(name),
                                 **{k.split("@")[1]: numbers(k) for k in branches}}
        entries.append(entry)
    log(f"done in {time.monotonic() - t_all:.1f} s")
    print(json.dumps({"packages": packages}))
    print(json.dumps({"retrieval": retrieval}))
    print(json.dumps({"rag": runs["rag"]}))
    print(json.dumps({"engine_options": options}))
    print(json.dumps({"ingest": runs["ingest"]}))
    print(json.dumps({"split": runs["split"]}))
    print(json.dumps({"modes": modes}))
    print(json.dumps({"draft": draft}))
    print(json.dumps({"fleet": fleet}))
    print(json.dumps({"mesh": mesh}))
    print(json.dumps({"moe": moe}))
    print(json.dumps({"train": train}))
    print(device["card"])
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device["kind"],
                                             "count": device["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
