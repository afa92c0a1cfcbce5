#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py                  # every phase, one card
    python3 chip_smoke.py --only kernels   # device, build and kernel phases

Phases, each raising on failure:

1. device  -- the card's name and power limit (nvidia-smi), torch and CUDA.
2. build   -- compile every kernel in githubrepostorag_tpu_torch/csrc with
              nvcc (one process per source, all at once).
3. kernels -- hold each kernel against its plain PyTorch version, element
              by element, at the shapes the serving path gives it, in
              float32 and bf16; time in bf16 the kernel, the plain
              version, and one PyTorch call computing the same function (scaled_dot_product_attention over pre-gathered
              K/V, a yardstick the port never calls); compute the least
              time the card could take for the same work.
4. model   -- Qwen2-7B at its published widths and depth, random bf16
              weights from a seeded generator on the card: forward_paged
              prefill logits with the kernels against the plain path.
5. engine  -- AsyncEngine(Engine(...)) at 7B serves a few requests
              (chunked prefill, a prefix-cache hit, one sampled row) after
              every kernel's launch count is set to 0; afterwards each
              kernel must have launched.
6. summary -- one JSON line per kernel list, then the result line.

There is no CPU fallback: without a card the script exits non-zero.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import subprocess
import sys
import time

import numpy as np

# published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# kernel vs plain version, element-wise |out - ref| <= atol + rtol * |ref|,
# by output dtype.  Both accumulate in float32 and round the output once: in
# bf16 the two f32 results (summed in another order) round to the same value
# or to neighbours one bf16 ulp apart (at most 2**-7 of |ref|); atol covers
# elements near 0, where the f32 summation order itself shows.  In float32
# only the summation order differs.
KERNEL_TOL = {"torch.bfloat16": (1e-5, 2 ** -7), "torch.float32": (1e-5, 0.0)}
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


def agreement(out, ref) -> dict:
    """Max |out - ref| and the largest share of the element-wise limit any
    element uses (over 1 fails)."""
    atol, rtol = KERNEL_TOL[str(out.dtype)]
    diff = (out.float() - ref.float()).abs()
    share = diff / (atol + rtol * ref.float().abs())
    return {"max_abs_err": diff.max().item(), "limit_share": share.max().item()}


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
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
            if "registers" in line or "spill" in line or "error" in line.lower():
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


def measure_kernel_a(case, timed: bool) -> dict:
    import torch
    import torch.nn.functional as F

    from githubrepostorag_tpu_torch.ops.fused_decode import (
        fused_window_attention, fused_window_attention_ref)
    from githubrepostorag_tpu_torch.ops.paged_attention import gather_kv

    args = (case["q"], case["k"], case["v"], case["bt"], case["cached"], case["new"])
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
    res["ms"] = time_ms(lambda: fused_window_attention(*args), 20)
    res["plain_ms"] = time_ms(lambda: fused_window_attention_ref(*args), 3, warmup=1)
    # yardstick: one SDPA call over K/V gathered beforehand
    k, v = gather_kv(case["k"], case["v"], case["bt"])  # [B, T, n_kv, hd]
    t = k.shape[1]
    kv_pos = torch.arange(t, device=k.device)
    q_pos = case["cached"].long()[:, None] + torch.arange(s, device=k.device)
    tot = torch.tensor(total, device=k.device)
    mask = (kv_pos[None, None] <= q_pos[:, :, None]) & (kv_pos[None, None] < tot[:, None, None])
    qs, ks, vs = case["q"].transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    res["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask[:, None], enable_gqa=True), 20)
    keys = sum(min(c + ti + 1, tt) for c, tt in zip(cached, total) for ti in range(s))
    flops = 4.0 * hd * n_q * keys
    nbytes = 2 * (2 * b * s * n_q * hd + 2 * sum(total) * n_kv * hd)
    res["bound_ms"], res["bound_by"] = bound(flops, nbytes)
    return res


def measure_kernel_b(case, timed: bool) -> dict:
    import torch
    import torch.nn.functional as F

    from githubrepostorag_tpu_torch.ops.paged_attention import gather_kv
    from githubrepostorag_tpu_torch.ops.paged_decode import (
        paged_attention_decode_staged, paged_attention_decode_staged_ref)

    args = (case["q"], case["k"], case["v"], case["bt"], case["pool"], case["sk"], case["sv"],
            case["staged_len"], case["layer"])
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
    res["ms"] = time_ms(lambda: paged_attention_decode_staged(*args), 50)
    res["plain_ms"] = time_ms(lambda: paged_attention_decode_staged_ref(*args), 5, warmup=1)
    pk, pv = gather_kv(case["k"][case["layer"]], case["v"][case["layer"]], case["bt"])
    k = torch.cat([pk, case["sk"].transpose(1, 2)], dim=1).transpose(1, 2)
    v = torch.cat([pv, case["sv"].transpose(1, 2)], dim=1).transpose(1, 2)
    t = pk.shape[1]
    n_steps = case["sk"].shape[2]
    valid = torch.cat([
        torch.arange(t, device=k.device)[None] < case["pool"][:, None],
        (torch.arange(n_steps, device=k.device) < sl)[None].expand(b, n_steps)], dim=1)
    qs = case["q"].transpose(1, 2)
    res["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
        qs, k, v, attn_mask=valid[:, None, None], enable_gqa=True), 50)
    keys = sum(pool) + b * sl
    flops = 4.0 * hd * n_q * keys
    nbytes = 2 * (2 * b * n_q * hd + 2 * keys * n_kv * hd)
    res["bound_ms"], res["bound_by"] = bound(flops, nbytes)
    return res


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

    # small cases in both dtypes: group 2, head_dim 64, a row with no KV
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        check(f"kernel A small {name} (group 2, hd 64)", measure_kernel_a(kernel_a_case(
            rng, dev, 3, 5, 4, 2, 64, 8, cached=[0, 9, 0], new=[5, 3, 0], dtype=dtype), False))
        check(f"kernel B small {name} (group 2, hd 64)", measure_kernel_b(kernel_b_case(
            rng, dev, 3, 4, 2, 64, 8, [0, 21, 40], n_steps=4, staged_len=2, dtype=dtype), False))

    # kernel A at the main prefill shape: B=4, S=512, 28/4 heads, hd 128,
    # ps 128, contexts to 4096; float32 for the tight limit, bf16 timed
    for dtype in (torch.float32, torch.bfloat16):
        main = kernel_a_case(rng, dev, 4, 512, 28, 4, 128, 128, cached=[0, 1024, 2560, 3584],
                             new=[512, 512, 300, 512], dtype=dtype)
        timed = dtype == torch.bfloat16
        res = check(f"kernel A B=4 S=512 ctx<=4096 {str(dtype)[6:]}", measure_kernel_a(main, timed))
        del main
    results["fused_window_attention"] = res

    # kernel B: rank-5 pools, layer index 1, mid-burst staged tail
    for b, dtype in ((8, torch.float32), (8, torch.bfloat16), (64, torch.bfloat16)):
        pool = rng.integers(1, 8193, size=b)
        pool[0] = 8192
        case = kernel_b_case(rng, dev, b, 28, 4, 128, 128, pool.tolist(), n_steps=8, staged_len=5,
                             dtype=dtype)
        timed = dtype == torch.bfloat16
        res = check(f"kernel B B={b} pool<=8192 n_steps 8 {str(dtype)[6:]}",
                    measure_kernel_b(case, timed))
        if timed:
            results["paged_attention_decode_staged" + ("" if b == 8 else f"@B{b}")] = res
        del case
    results["paged_attention_decode_staged"]["max_abs_err"] = max(
        results["paged_attention_decode_staged"]["max_abs_err"],
        results["paged_attention_decode_staged@B64"]["max_abs_err"])

    limits = ", ".join(f"{k[6:]} {a:g} + {r:g}|ref|" for k, (a, r) in KERNEL_TOL.items())
    bad = [label for label, r in checks if not r["limit_share"] <= 1.0]
    if bad:
        raise RuntimeError(f"kernel and plain version disagree beyond {limits}: {bad}")
    log(f"kernels agree with their plain versions element-wise within {limits}")
    return results


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


def phase_model(cfg, params) -> None:
    """forward_paged prefill logits, kernels against the plain path, at
    Qwen2-7B width and depth.  In float32 (weights upcast) the two paths do
    the same arithmetic in another order, so they must agree tightly.  In
    bf16 both round at other places, and a random-weight 28-layer model
    amplifies that; there the kernel path must be no less accurate than
    the plain path, both measured against the float32 plain logits."""
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
        log(f"forward_paged 7B [2, 512] {str(dtype)[6:]} use_kernels={use_kernels}: "
            f"{(time.monotonic() - t0) * 1e3:.1f} ms host wall")
        out = logits[valid]  # [valid positions, V]
        if not torch.isfinite(out).all():
            raise RuntimeError("non-finite 7B logits")
        return out

    def rel(a, ref):
        return ((a - ref).norm() / ref.norm()).item()

    bf_kern = run(params, torch.bfloat16, True)
    bf_plain = run(params, torch.bfloat16, False)
    p32 = {k: (v.float() if torch.is_tensor(v) else {n: w.float() for n, w in v.items()})
           for k, v in params.items()}
    f_kern = run(p32, torch.float32, True)
    f_plain = run(p32, torch.float32, False)
    del p32

    err32 = rel(f_kern, f_plain)
    atol = LOGITS_RTOL_F32 * f_plain.pow(2).mean().sqrt().item()
    top2 = f_plain.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > atol
    agree = (f_kern.argmax(-1) == f_plain.argmax(-1))[decided]
    log(f"7B f32 logits kernels vs plain: rel err {err32:.3g} (limit {LOGITS_RTOL_F32}); argmax "
        f"agrees at {int(agree.sum())}/{int(decided.sum())} positions whose top-2 margin > {atol:.3g}")
    if err32 > LOGITS_RTOL_F32 or not bool(agree.all()):
        raise RuntimeError("7B float32 forward_paged with kernels disagrees with the plain path")
    e_kern, e_plain = rel(bf_kern, f_plain), rel(bf_plain, f_plain)
    log(f"7B bf16 logits vs f32 plain: kernels {e_kern:.3g}, plain {e_plain:.3g}; "
        f"kernels vs plain {rel(bf_kern, bf_plain):.3g}")
    if e_kern > LOGITS_BF16_SLACK * e_plain:
        raise RuntimeError("7B bf16 forward_paged with kernels is less accurate than the plain path")


def phase_engine(cfg, params) -> dict:
    import torch

    from githubrepostorag_tpu_torch.ops.fused_decode import fused_window_attention
    from githubrepostorag_tpu_torch.ops.paged_decode import paged_attention_decode_staged
    from githubrepostorag_tpu_torch.serving import AsyncEngine, Engine, SamplingParams

    engine = Engine(params, cfg, page_size=128, num_pages=256, max_num_seqs=8,
                    prefill_chunk=512, decode_burst=8, max_seq_len=11712, device="cuda")
    t0 = time.monotonic()
    engine.warmup()
    torch.cuda.synchronize()
    log(f"engine warmup {time.monotonic() - t0:.1f} s")

    rng = np.random.default_rng(SEED + 2)
    prefix = rng.integers(0, cfg.vocab_size, 1024).tolist()
    wave1 = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (100, 700, 1500, 3000)]
    wave1.append(prefix + rng.integers(0, cfg.vocab_size, 200).tolist())
    second = prefix + rng.integers(0, cfg.vocab_size, 300).tolist()
    # decode wave: 8 rows prefill in one chunk together, then only decode
    decode_wave = [rng.integers(0, cfg.vocab_size, 256).tolist() for _ in range(8)]
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
            return first, last, streamed, decoded, t_start, t_mid
        finally:
            await aeng.stop()

    fused_window_attention.launches = 0
    paged_attention_decode_staged.launches = 0
    hits_before = engine._allocator.hit_tokens
    first, last, streamed, decoded, t_start, t_mid = asyncio.run(serve())
    torch.cuda.synchronize()
    launches = {"fused_window_attention": fused_window_attention.launches,
                "paged_attention_decode_staged": paged_attention_decode_staged.launches}
    hit = engine._allocator.hit_tokens - hits_before

    for res, want in [(r, n_new) for r in first + [last]] + [(r, n_decode) for r in decoded]:
        if res.finish_reason != "length" or len(res.output_tokens) != want:
            raise RuntimeError(f"{res.request_id}: {res.finish_reason} after "
                               f"{len(res.output_tokens)} tokens ({res.error})")
        if not all(0 <= tok < cfg.vocab_size for tok in res.output_tokens):
            raise RuntimeError(f"{res.request_id}: token outside the vocabulary")
    if streamed != last.output_tokens:
        raise RuntimeError("streamed tokens differ from the final result")
    if hit < 1024:
        raise RuntimeError(f"prefix cache hit {hit} tokens, expected >= 1024")
    for name, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"{name} never launched on the main path")
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
    log(f"engine on {torch.cuda.get_device_name(0)}: {json.dumps(stats)}")
    profile_decode(engine, decode_wave, SamplingParams(temperature=0.0, max_tokens=17))
    return stats


def profile_decode(engine, prompts, sp) -> None:
    """Where a decode-heavy request batch's time goes: the device's idle
    share (one minus kernel time, from a torch.profiler trace of the card
    only, over the wall time of the same call run unprofiled) and the
    kernels that take most of it.  Outside the timed engine numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    engine.generate(prompts, sp)  # same shapes, so the measured runs are warm
    torch.cuda.synchronize()
    t0 = time.monotonic()
    engine.generate(prompts, sp)
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        engine.generate(prompts, sp)
        torch.cuda.synchronize()
        prof_wall_ms = (time.monotonic() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if "CUDA" in str(e.device_type)]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"profile: {len(prompts)} rows x {sp.max_tokens} tokens, wall {wall_ms:.1f} ms unprofiled "
        f"({prof_wall_ms:.1f} ms profiled), device busy {busy_ms:.1f} ms, idle "
        f"{100 * (1 - busy_ms / wall_ms):.1f}% of the unprofiled wall")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d}x  {e.key[:90]}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", choices=["kernels"], default=None,
                        help="run the device, build and kernel phases only")
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
    phase_build()
    kres = phase_kernels()
    if args.only == "kernels":
        log(f"done in {time.monotonic() - t_all:.1f} s")
        return 0
    cfg, params = make_7b_params()
    phase_model(cfg, params)
    estats = phase_engine(cfg, params)

    sources = {
        "fused_window_attention": ("githubrepostorag_tpu_torch/csrc/fused_window_attention.cu",
                                   "githubrepostorag_tpu/ops/fused_decode.py:232"),
        "paged_attention_decode_staged": ("githubrepostorag_tpu_torch/csrc/paged_decode_staged.cu",
                                          "githubrepostorag_tpu/ops/pallas_paged.py:395"),
    }
    entries = []
    for name, (source, replaces) in sources.items():
        r = kres[name]
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": estats["launches"][name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    log(f"done in {time.monotonic() - t_all:.1f} s")
    print(device["card"])
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device["kind"],
                                             "count": device["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
