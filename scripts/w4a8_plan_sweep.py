#!/usr/bin/env python3
"""Kernel E's launch plan against the alternatives it rejects, on one card.

    python3 scripts/w4a8_plan_sweep.py            # from the repository root

At the Qwen2-7B decode shapes (group 64, bf16 x, random weights), each
variant of ``ops.int4_matmul._plan_w4a8``'s plan runs through the real
wrapper (``w4a8_matmul``, both kernels), is held to the plain route within
``chip_smoke.GEMM_ATOL`` and timed by device time (torch.profiler, both
kernels): groups per ring stage (1, 2, 4) and the K split rule (the plan's
against one wave of blocks, and at M = 64 against 1, 2 and 4 splits).  A
variant is sized by the plan's own sizing (``w4a8_mma_plan``) and launched
through ``_w4a8_launch``.  Prints one JSON line per shape; needs CUDA.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("w4a8_plan_sweep: no CUDA device", file=sys.stderr)
        return 1
    from githubrepostorag_tpu_torch.models.quant import quantize_weight4
    from githubrepostorag_tpu_torch.ops import int4_matmul as ops

    cs.phase_device()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 7)
    for name, m in (("wqkv", 8), ("wo", 8), ("wgu", 8), ("wd", 8), ("lm_head", 8),
                    ("wqkv", 64), ("wo", 64), ("wgu", 64), ("wd", 64)):
        k, n = cs.Q7B_SHAPES[name]
        w = quantize_weight4(torch.randn((k, n), generator=gen, device="cuda") * 0.02, cs.GROUP)
        out_dtype = torch.float32 if name == "lm_head" else torch.bfloat16
        x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
        ref = ops._w4a8(x, *w, out_dtype, ops.w4a8_matmul_ref)
        scale = cs.w4a8_scale(x, w)
        base = ops._plan_w4a8(m, k, n, cs.GROUP, w.q.data_ptr(), w.s.data_ptr(),
                              w.zs.data_ptr(), 132)
        n_g, tiles = k // cs.GROUP, base.row_blocks * base.col_tiles
        fn = lambda: ops.w4a8_matmul(x, *w, out_dtype)  # noqa: E731
        row = {"plan": {k_: v for k_, v in base._asdict().items()
                        if k_ in ("block_m", "splits", "groups_per_split", "groups_per_stage",
                                  "stages")},
               "plan_us": sum(cs.device_us(fn).values())}
        s_wave = min(n_g, -(-132 // tiles))  # the fewest splits giving every SM a block
        variants = {f"groups_per_stage_{g}": (base.groups_per_split, g, base.block_m)
                    for g in (1, 2) if g != base.groups_per_stage}
        variants[f"one_wave_splits_{s_wave}"] = (-(-n_g // s_wave), base.groups_per_stage,
                                                 base.block_m)
        if m == 64:
            for s in (1, 2, 4):
                variants[f"splits_{s}"] = (-(-n_g // s), base.groups_per_stage, base.block_m)
        for key, (gps, groups, block_m) in variants.items():
            plan = ops.w4a8_mma_plan(m, n_g, n, cs.GROUP, base.loader == "tma", block_m, gps,
                                     groups)
            run = lambda: ops._w4a8_launch(x, *w, out_dtype, plan)[0]  # noqa: E731
            out = run()
            torch.cuda.synchronize()
            if not cs.gemm_agreement(out, ref, scale)["limit_share"] <= 1.0:
                raise RuntimeError(f"{name} M={m} {key}: disagrees with the plain route")
            row[key] = {"us": sum(cs.device_us(run).values()), "blocks": plan.blocks}
        print(json.dumps({"shape": f"{name}@M{m}", **row}), flush=True)
        del w
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
