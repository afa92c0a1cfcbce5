"""The port's packed prefill attention against the JAX package (CPU,
float32, tolerance 2e-5 as tests/test_packed_prefill.py uses):

  _segment_scatter_indices    vs ops/packed_prefill._segment_scatter_indices
  packed_prefill_attention    vs ops/packed_prefill.packed_prefill_attention
                              (use_pallas=True runs kernel C's Pallas
                              counterpart in interpret mode; False its XLA
                              path), full-precision pools
  fused_packed_attention      vs ops/fused_decode.fused_packed_attention,
                              int8 and int4 pools (interpret mode)

on live tokens: the JAX functions leave finite garbage at padding tokens,
the port's kernel C path writes 0 there.  Cases: three segments (a chunk
resuming mid-prompt, a full chunk, a tail deep into a page) and a segment
that resumes mid-page.  On CPU tensors the kernel wrappers run their plain
versions and launch nothing."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from githubrepostorag_tpu.ops import packed_prefill as jpp
from githubrepostorag_tpu.ops.fused_decode import fused_packed_attention as j_fused_packed
from githubrepostorag_tpu_torch.ops import packed_prefill as tpp
from githubrepostorag_tpu_torch.ops.fused_decode import (
    fused_packed_attention,
    fused_window_attention,
)

ATOL = 2e-5
N_KV, GROUP, PS, HD = 2, 2, 8, 16


def _case(seed, cached, new, tq, budget):
    """Segments packed back to back (each owns three pages of a shuffled
    pool) and padding tokens up to ``budget``."""
    rng = np.random.default_rng(seed)
    r, pages = len(cached), 4 * len(cached)
    perm = rng.permutation(pages)
    bt = np.stack([perm[3 * s: 3 * s + 3] for s in range(r)]).astype(np.int32)
    seg, pos = [], []
    for s in range(r):
        seg += [s] * new[s]
        pos += list(range(cached[s], cached[s] + new[s]))
    pad = budget - len(seg)
    seg += [r] * pad
    pos += [0] * pad
    kp = rng.normal(size=(N_KV, pages, PS, HD)).astype(np.float32)
    vp = rng.normal(size=(N_KV, pages, PS, HD)).astype(np.float32)
    q = rng.normal(size=(budget, N_KV * GROUP, HD)).astype(np.float32)
    return dict(q=q, kp=kp, vp=vp, bt=bt, cached=np.asarray(cached, np.int32),
                new=np.asarray(new, np.int32), seg=np.asarray(seg, np.int32),
                pos=np.asarray(pos, np.int32), tq=tq)


CASES = {
    "three_segments": dict(seed=0, cached=[5, 0, 11], new=[3, 8, 4], tq=8, budget=16),
    "mid_page_resume": dict(seed=1, cached=[13, 0], new=[6, 2], tq=6, budget=10),
}


def _args(c, lib):
    names = ("q", "kp", "vp", "bt", "cached", "new", "seg", "pos")
    return [lib(c[n]) for n in names]


def test_segment_scatter_indices_matches_jax():
    c = _case(**CASES["three_segments"])
    j = jpp._segment_scatter_indices(*(jnp.asarray(c[n]) for n in ("seg", "pos", "cached")),
                                     c["tq"])
    t = tpp._segment_scatter_indices(*(torch.from_numpy(c[n]) for n in ("seg", "pos", "cached")),
                                     c["tq"])
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert (t.numpy()[c["seg"] >= 3] == 3 * c["tq"]).all()  # padding -> sentinel


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("name", sorted(CASES))
def test_packed_prefill_attention_matches_jax(name, use_pallas):
    c = _case(**CASES[name])
    j_out = np.asarray(jpp.packed_prefill_attention(*_args(c, jnp.asarray), tq=c["tq"],
                                                    use_pallas=use_pallas))
    live = c["seg"] < len(c["cached"])
    before = tpp.packed_prefill_attention_seg.launches
    t_out = tpp.packed_prefill_attention(*_args(c, torch.from_numpy), tq=c["tq"],
                                         use_kernels=use_pallas)
    assert tpp.packed_prefill_attention_seg.launches == before
    np.testing.assert_allclose(t_out.numpy()[live], j_out[live], atol=ATOL, rtol=0)
    assert not t_out[~torch.from_numpy(live)].any()  # padding tokens get 0


@pytest.mark.parametrize("quant", [8, 4])
def test_fused_packed_attention_quantized_matches_jax(quant):
    c = _case(**CASES["mid_page_resume"])
    rng = np.random.default_rng(quant)
    shape = c["kp"].shape
    if quant == 8:
        kq = rng.integers(-127, 128, shape).astype(np.int8)
        vq = rng.integers(-127, 128, shape).astype(np.int8)
    else:
        kq = rng.integers(0, 256, shape[:-1] + (HD // 2,)).astype(np.uint8)
        vq = rng.integers(0, 256, shape[:-1] + (HD // 2,)).astype(np.uint8)
    ks, vs = (rng.uniform(0.005, 0.05, shape[:2]).astype(np.float32) for _ in range(2))
    c.update(kp=kq, vp=vq)
    j_out = np.asarray(j_fused_packed(*_args(c, jnp.asarray), tq=c["tq"], k_scales=jnp.asarray(ks),
                                      v_scales=jnp.asarray(vs)))
    t_args = _args(c, torch.from_numpy)
    scales = dict(k_scales=torch.from_numpy(ks), v_scales=torch.from_numpy(vs))
    t_out = fused_packed_attention(*t_args, tq=c["tq"], **scales)
    live = c["seg"] < len(c["cached"])
    np.testing.assert_allclose(t_out.numpy()[live], j_out[live], atol=ATOL, rtol=0)
    assert torch.isfinite(t_out).all()  # padding tokens: finite, never read
    # the packed entry point routes quantized pools to kernel A's path
    before = (tpp.packed_prefill_attention_seg.launches, fused_window_attention.launches)
    routed = tpp.packed_prefill_attention(*t_args, tq=c["tq"], **scales)
    assert torch.equal(routed, t_out)
    assert (tpp.packed_prefill_attention_seg.launches, fused_window_attention.launches) == before


# ---- kernel C on the card: the tensor-core body over the packed buffer ----

from tests.test_torch_attention_kernels import _prefill_tiles  # noqa: E402


@pytest.mark.parametrize("group,n_kv,cached,new,tq,budget,stages", [
    # group 7 at hd 64 over 8-key pages: a 70-token chunk resuming mid-page
    # (490 flat rows, 4 tiles), a fresh one, an empty segment, padding
    (7, 1, [33, 0, 5], [70, 19, 0], 70, 96, (9, 7)),
    (2, 2, [13, 0], [6, 2], 6, 10, (4, 4)),
])
def test_prefill_tiles_match_kernel_c_pallas(group, n_kv, cached, new, tq, budget, stages):
    """Kernel C's arithmetic (kernel A's body, tokens through row_of)
    emulated in float32 on bf16-representable operands, held to the Pallas
    kernel in interpret mode on live tokens; padding tokens stay 0."""
    rng = np.random.default_rng(group)
    hd, ps, r = 64, 8, len(cached)
    total = [c + n for c, n in zip(cached, new)]
    need = [-(-t // ps) for t in total]
    pages = sum(need) + 2
    perm, at = rng.permutation(pages), 0
    bt = np.zeros((r, max(need)), dtype=np.int32)
    for s, n in enumerate(need):
        bt[s, :n] = perm[at:at + n]
        at += n
    seg, pos = [], []
    for s in range(r):
        seg += [s] * new[s]
        pos += list(range(cached[s], cached[s] + new[s]))
    seg += [r] * (budget - len(seg))
    pos += [0] * (budget - len(pos))
    bf = lambda x: torch.from_numpy(x).to(torch.bfloat16).float().numpy()  # noqa: E731
    q = bf(rng.normal(size=(budget, n_kv * group, hd)).astype(np.float32))
    kp, vp = (bf(rng.normal(size=(n_kv, pages, ps, hd)).astype(np.float32)) for _ in range(2))
    c = dict(q=q, kp=kp, vp=vp, bt=bt, cached=np.asarray(cached, np.int32),
             new=np.asarray(new, np.int32), seg=np.asarray(seg, np.int32),
             pos=np.asarray(pos, np.int32))
    # the kernel's token map: window position i of segment s is packed token row_of[s * tq + i]
    windows = [[next(j for j in range(budget) if seg[j] == s and pos[j] == cached[s] + i)
                for i in range(new[s])] for s in range(r)]
    emu, walked, masked = _prefill_tiles(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp), torch.from_numpy(bt),
        c["cached"], c["new"], windows)
    assert (walked, masked) == stages
    live = c["seg"] < r
    assert not emu[~torch.from_numpy(live)].any()  # padding tokens are never written
    j_out = np.asarray(jpp.packed_prefill_attention(*_args(c, jnp.asarray), tq=tq,
                                                    use_pallas=True))
    np.testing.assert_allclose(emu.numpy()[live], j_out[live], atol=ATOL, rtol=0)
