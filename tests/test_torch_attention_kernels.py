"""The plain versions of the ported attention kernels against the Pallas
TPU kernels they replace, run in interpret mode on the CPU:

  fused_window_attention_ref        vs ops/fused_decode.fused_window_attention
  paged_attention_decode_staged_ref vs ops/pallas_paged.paged_attention_decode_staged
  paged_attention_decode_ref        vs ops/pallas_paged.paged_attention_decode

Same numpy inputs, float32, tolerance 1e-5 absolute (the same f32
arithmetic in another summation order).  Cases: GQA groups 2 and 7,
windows of 1 token and longer than a page, rows with no valid KV, shuffled
block tables, rank-5 pools with a layer index.  On CPU tensors the kernel
wrappers run these plain versions and launch nothing."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from githubrepostorag_tpu.ops.fused_decode import fused_window_attention as j_window
from githubrepostorag_tpu.ops.pallas_paged import paged_attention as j_paged_attention
from githubrepostorag_tpu.ops.pallas_paged import paged_attention_decode as j_decode
from githubrepostorag_tpu.ops.pallas_paged import paged_attention_decode_staged as j_staged
from githubrepostorag_tpu_torch.ops.fused_decode import (
    fused_window_attention,
    fused_window_attention_ref,
)
from githubrepostorag_tpu_torch.ops.paged_decode import (
    paged_attention,
    paged_attention_decode,
    paged_attention_decode_staged,
    paged_attention_decode_staged_ref,
)

ATOL = 1e-5
PS, HD, MAX_PAGES = 4, 16, 5


def _tables(rng, b, num_pages, lens):
    """Disjoint shuffled pages per row (holes between a row's pages)."""
    perm = rng.permutation(num_pages)
    bt = np.zeros((b, MAX_PAGES), dtype=np.int32)
    at = 0
    for i, n in enumerate(lens):
        need = -(-int(n) // PS)
        bt[i, :need] = perm[at:at + need]
        at += need
    return bt


@pytest.mark.parametrize("group,s_w,cached,new", [
    (2, 1, [7, 0, 12], [1, 0, 1]),      # decode-shaped window, a padding row
    (7, 1, [3, 9], [1, 1]),
    (2, 6, [0, 5, 13], [6, 4, 0]),      # window longer than a page
    (7, 9, [2, 0], [9, 7]),
])
def test_window_ref_matches_pallas_interpret(group, s_w, cached, new):
    rng = np.random.default_rng(group * 100 + s_w)
    n_kv, num_pages = 2, 24
    b = len(cached)
    total = [c + n for c, n in zip(cached, new)]
    q = rng.normal(size=(b, s_w, n_kv * group, HD)).astype(np.float32)
    kp = rng.normal(size=(n_kv, num_pages, PS, HD)).astype(np.float32)
    vp = rng.normal(size=(n_kv, num_pages, PS, HD)).astype(np.float32)
    bt = _tables(rng, b, num_pages, total)
    cl, nl = np.asarray(cached, np.int32), np.asarray(new, np.int32)
    j_out = np.asarray(j_window(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
                                jnp.asarray(cl), jnp.asarray(nl), interpret=True))
    args = [torch.from_numpy(x) for x in (q, kp, vp, bt, cl, nl)]
    t_out = fused_window_attention_ref(*args)
    np.testing.assert_allclose(t_out.numpy(), j_out, atol=ATOL, rtol=0)
    for i, t in enumerate(total):
        if t == 0:  # no valid KV: exactly zero, never NaN
            assert not t_out[i].any()
    before = fused_window_attention.launches
    assert torch.equal(fused_window_attention(*args), t_out)  # CPU -> plain version
    assert fused_window_attention.launches == before


@pytest.mark.parametrize("group,pool_lens,staged_len", [
    (2, [13, 0, 20], 3),   # a row with an empty pool prefix
    (7, [5, 17], 1),
    (7, [20, 8], 4),
])
def test_staged_ref_matches_pallas_interpret(group, pool_lens, staged_len):
    rng = np.random.default_rng(group * 10 + staged_len)
    L, n_kv, num_pages, n_steps, layer = 3, 2, 16, 4, 1
    b = len(pool_lens)
    q = rng.normal(size=(b, 1, n_kv * group, HD)).astype(np.float32)
    kp = rng.normal(size=(L, n_kv, num_pages, PS, HD)).astype(np.float32)
    vp = rng.normal(size=(L, n_kv, num_pages, PS, HD)).astype(np.float32)
    sk = rng.normal(size=(b, n_kv, n_steps, HD)).astype(np.float32)
    sv = rng.normal(size=(b, n_kv, n_steps, HD)).astype(np.float32)
    bt = _tables(rng, b, num_pages, pool_lens)
    pl = np.asarray(pool_lens, np.int32)
    j_out = np.asarray(j_staged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt), jnp.asarray(pl),
        jnp.asarray(sk), jnp.asarray(sv), jnp.asarray([staged_len], jnp.int32),
        jnp.asarray([layer], jnp.int32), interpret=True))
    args = [torch.from_numpy(x) for x in (q, kp, vp, bt, pl, sk, sv)]
    t_out = paged_attention_decode_staged_ref(*args, staged_len, layer)
    np.testing.assert_allclose(t_out.numpy(), j_out, atol=ATOL, rtol=0)
    before = paged_attention_decode_staged.launches
    assert torch.equal(paged_attention_decode_staged(*args, staged_len, layer), t_out)
    assert paged_attention_decode_staged.launches == before


def test_staged_ref_with_no_valid_kv_is_zero():
    q = torch.ones(1, 1, 4, HD)
    kp = torch.ones(1, 2, 2, PS, HD)
    st = torch.ones(1, 2, 2, HD)
    out = paged_attention_decode_staged_ref(q, kp, kp, torch.zeros(1, 1, dtype=torch.int32),
                                            torch.zeros(1, dtype=torch.int32), st, st, 0, 0)
    assert not out.any()


# ---- quantized pools: kernel A's int8 / int4 branches, kernel B's int8 ----

def _quant_pages(rng, shape, quant):
    """Random int8 codes or uint8 nibble-plane bytes, and per-(kv head,
    page) scales that differ everywhere, so a wrong scale index shows."""
    if quant == 8:
        codes = rng.integers(-127, 128, shape).astype(np.int8)
    else:
        codes = rng.integers(0, 256, shape[:-1] + (shape[-1] // 2,)).astype(np.uint8)
    return codes, rng.uniform(0.005, 0.05, shape[:-2]).astype(np.float32)


def _assert_close(out: torch.Tensor, ref: np.ndarray) -> None:
    """float32: 2e-5.  bf16: one bf16 ulp of the reference (2**-7 relative),
    both sides accumulating in float32 and rounding the output once."""
    if out.dtype == torch.bfloat16:
        np.testing.assert_allclose(out.float().numpy(), ref.astype(np.float32),
                                   atol=1e-5, rtol=2 ** -7)
    else:
        np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant,s_w,cached,new", [
    (8, 1, [9], [1]),
    (8, 5, [0, 6, 11], [5, 3, 0]),
    (4, 1, [3, 0, 14], [1, 1, 0]),
    (4, 5, [7], [5]),
])
def test_window_ref_quantized_matches_pallas_interpret(quant, s_w, cached, new, dtype):
    rng = np.random.default_rng(quant * 10 + s_w)
    n_kv, group, num_pages = 2, 2, 16
    b = len(cached)
    total = [c + n for c, n in zip(cached, new)]
    q = rng.normal(size=(b, s_w, n_kv * group, HD)).astype(np.float32)
    kq, ks = _quant_pages(rng, (n_kv, num_pages, PS, HD), quant)
    vq, vs = _quant_pages(rng, (n_kv, num_pages, PS, HD), quant)
    bt = _tables(rng, b, num_pages, total)
    cl, nl = np.asarray(cached, np.int32), np.asarray(new, np.int32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    j_out = np.asarray(j_window(jnp.asarray(q, jdt), *(jnp.asarray(x) for x in (kq, vq, bt, cl, nl,
                                                                               ks, vs)),
                                interpret=True).astype(jnp.float32))
    args = [torch.from_numpy(q).to(dtype)] + [torch.from_numpy(x) for x in (kq, vq, bt, cl, nl)]
    scales = [torch.from_numpy(ks), torch.from_numpy(vs)]
    t_out = fused_window_attention_ref(*args, *scales)
    assert t_out.dtype == dtype
    _assert_close(t_out, j_out)
    before = dict(fused_window_attention.launches_by_pool)
    assert torch.equal(fused_window_attention(*args, *scales), t_out)  # CPU -> plain version
    assert fused_window_attention.launches_by_pool == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_staged_ref_int8_matches_pallas_interpret(dtype):
    """Rank-5 int8 pools with [L, n_kv, P] scales read at layer 1, and a
    staged tail in the activation dtype."""
    rng = np.random.default_rng(77)
    L, n_kv, group, num_pages, n_steps, layer, staged_len = 3, 2, 7, 16, 4, 1, 3
    pool_lens = [13, 0, 20]
    b = len(pool_lens)
    q = rng.normal(size=(b, 1, n_kv * group, HD)).astype(np.float32)
    kq, ks = _quant_pages(rng, (L, n_kv, num_pages, PS, HD), 8)
    vq, vs = _quant_pages(rng, (L, n_kv, num_pages, PS, HD), 8)
    sk = rng.normal(size=(b, n_kv, n_steps, HD)).astype(np.float32)
    sv = rng.normal(size=(b, n_kv, n_steps, HD)).astype(np.float32)
    bt = _tables(rng, b, num_pages, pool_lens)
    pl = np.asarray(pool_lens, np.int32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    j_out = np.asarray(j_staged(
        jnp.asarray(q, jdt), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(bt), jnp.asarray(pl),
        jnp.asarray(sk, jdt), jnp.asarray(sv, jdt), jnp.asarray([staged_len], jnp.int32),
        jnp.asarray([layer], jnp.int32), jnp.asarray(ks), jnp.asarray(vs),
        interpret=True).astype(jnp.float32))
    args = [torch.from_numpy(q).to(dtype), torch.from_numpy(kq), torch.from_numpy(vq),
            torch.from_numpy(bt), torch.from_numpy(pl), torch.from_numpy(sk).to(dtype),
            torch.from_numpy(sv).to(dtype)]
    scales = dict(k_scales=torch.from_numpy(ks), v_scales=torch.from_numpy(vs))
    t_out = paged_attention_decode_staged_ref(*args, staged_len, layer, **scales)
    _assert_close(t_out, j_out)
    before = dict(paged_attention_decode_staged.launches_by_pool)
    assert torch.equal(paged_attention_decode_staged(*args, staged_len, layer, **scales), t_out)
    assert paged_attention_decode_staged.launches_by_pool == before


# ---- kernel F: paged_attention_decode and its dispatcher ------------------
#
# The cases of tests/test_pallas_paged.py: single rows of 13, 16 and 1
# tokens, a ragged batch with a padding row (no key: exactly 0 on both
# sides), and Qwen2-7B's group of 7.  float32 within 1e-5; bf16 within one
# bf16 ulp of the Pallas kernel (both sum in f32 and round the output once).

F_CASES = {
    "single_13": (0, 1, 4, 2, 32, 8, 16, 4, [13]),
    "single_16": (0, 1, 4, 2, 32, 8, 16, 4, [16]),
    "single_1": (0, 1, 4, 2, 32, 8, 16, 4, [1]),
    "ragged_with_padding_row": (1, 4, 8, 2, 64, 16, 32, 4, [50, 7, 0, 33]),
    "group_of_seven": (2, 2, 28, 4, 64, 16, 24, 6, [80, 42]),
}


def _f_case(seed, b, n_q, n_kv, hd, ps, num_pages, max_pages, lens, s=1):
    """tests/test_pallas_paged.py's inputs: distinct random pages per row,
    cached = len - 1 and one new token (0 and 0 for a padding row); with
    ``s`` > 1 a prefill chunk of ``s`` tokens instead."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, n_q, hd)).astype(np.float32)
    kp = rng.normal(size=(n_kv, num_pages, ps, hd)).astype(np.float32)
    vp = rng.normal(size=(n_kv, num_pages, ps, hd)).astype(np.float32)
    perm = rng.permutation(num_pages)
    bt = np.zeros((b, max_pages), dtype=np.int32)
    taken = 0
    for row in range(b):
        need = -(-int(lens[row]) // ps) if lens[row] else 0
        bt[row, :need] = perm[taken: taken + need]
        taken += need
    new = np.asarray([min(s, n) for n in lens], dtype=np.int32)
    cached = np.asarray(lens, dtype=np.int32) - new
    return q, kp, vp, bt, cached, new


def _torch_and_jax(arrays, dtype):
    """The same values for both packages: float arrays rounded to ``dtype``
    once, on the torch side."""
    ts = [torch.from_numpy(a).to(dtype) if a.dtype == np.float32 else torch.from_numpy(a)
          for a in arrays]
    js = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) if t.dtype == torch.bfloat16
          else jnp.asarray(t.numpy()) for t in ts]
    return ts, js


def _assert_one_bf16_ulp(out: torch.Tensor, ref: torch.Tensor):
    a, b = out.float(), ref.float()
    assert bool(((a - b).abs() <= 2 ** -7 * torch.maximum(a.abs(), b.abs())).all()), \
        (a - b).abs().max().item()


@pytest.mark.parametrize("name,dtype", [(n, torch.float32) for n in F_CASES] + [
    (n, torch.bfloat16) for n in ("ragged_with_padding_row", "group_of_seven")])
def test_paged_decode_ref_matches_pallas_interpret(name, dtype):
    seed, b, n_q, n_kv, hd, ps, num_pages, max_pages, lens = F_CASES[name]
    ts, js = _torch_and_jax(_f_case(seed, b, n_q, n_kv, hd, ps, num_pages, max_pages, lens),
                            dtype)
    out = paged_attention_decode(*ts)
    ref = torch.from_numpy(np.asarray(j_decode(*js, interpret=True)).astype(np.float32))
    assert out.dtype == dtype and out.shape == (b, 1, n_q, hd)
    if dtype == torch.float32:
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5, rtol=1e-5)
    else:
        _assert_one_bf16_ulp(out, ref)
    for row, n in enumerate(lens):
        if n == 0:  # no key: exactly 0 on both sides (the JAX kernel's safe_l)
            assert not out[row].float().any() and not ref[row].any()
    assert paged_attention_decode.launches == 0  # CPU tensors launch nothing


@pytest.mark.parametrize("s", [1, 3])
def test_paged_attention_dispatcher_matches_jax(s):
    seed, b, n_q, n_kv, hd, ps, num_pages, max_pages, lens = F_CASES["ragged_with_padding_row"]
    arrays = _f_case(seed, b, n_q, n_kv, hd, ps, num_pages, max_pages, lens, s=s)
    ts, js = _torch_and_jax(arrays, torch.float32)
    out = paged_attention(*ts)
    # every row, the padding row too: 0 from kernel F at S = 1, the mean of
    # V from the gather path at S > 1, on both sides
    np.testing.assert_allclose(out.numpy(), np.asarray(j_paged_attention(*js)),
                               atol=1e-5, rtol=1e-5)
    if s == 1:
        assert not out[lens.index(0)].any()


@pytest.mark.parametrize("bad", ["window", "int8_pools", "uint8_pools"])
def test_paged_decode_refuses_before_launch(bad):
    """S != 1 and quantized pools raise on any device, before a launch: the
    TPU kernel takes neither (its pools carry no scales)."""
    seed, b, n_q, n_kv, hd, ps, num_pages, max_pages, lens = F_CASES["single_13"]
    q, kp, vp, bt, cached, new = (torch.from_numpy(a) for a in _f_case(
        seed, b, n_q, n_kv, hd, ps, num_pages, max_pages, lens, s=3 if bad == "window" else 1))
    if bad != "window":
        code = torch.int8 if bad == "int8_pools" else torch.uint8
        kp, vp = kp.to(code), vp.to(code)
    with pytest.raises(ValueError, match="paged_attention_decode"):
        paged_attention_decode(q, kp, vp, bt, cached, new)
    assert paged_attention_decode.launches == 0


# ---- kernels B and F on the card: the split-K plan and its arithmetic -----
#
# On the card both kernels cut every (row, kv head)'s block table into
# splits of whole pages (``_plan_decode``, static shapes only), write one
# unnormalised online-softmax partial (m, l, acc) per split, and merge the
# partials in split order, then B's staged tail one key at a time.  The
# plan is pure Python; the arithmetic is emulated here in plain torch and
# held to the plain versions and to the Pallas kernels in interpret mode.

import inspect  # noqa: E402

from githubrepostorag_tpu_torch.ops.paged_decode import (  # noqa: E402
    TILE_KEYS,
    _plan_decode,
    paged_attention_decode_ref,
)


def _split_ranges(plan, max_pages):
    return [(s * plan.pages_per_split, min((s + 1) * plan.pages_per_split, max_pages))
            for s in range(plan.n_splits)]


@pytest.mark.parametrize("b,n_kv,max_pages,ps,want", [
    (1, 4, 64, 128, (2, 32)),     # 7B heads, 8192-key tables: 128 blocks, not 32
    (8, 4, 64, 128, (8, 8)),      # 1024-key splits
    (64, 4, 64, 128, (8, 8)),
    (8, 4, 92, 128, (8, 12)),     # the engine's table at max_seq_len 11712
    (3, 2, 5, 8, (8, 1)),         # 8-key pages: eight to a 64-key tile
    (3, 2, 125, 8, (8, 16)),
    (64, 4, 4096, 8, (128, 32)),  # the kernel's page list at its longest
    (2, 4, 3, 256, (1, 3)),
])
def test_decode_plan_splits_whole_pages(b, n_kv, max_pages, ps, want):
    plan = _plan_decode(b, n_kv, max_pages, ps)
    assert (plan.pages_per_split, plan.n_splits) == want
    assert plan.blocks == b * n_kv * plan.n_splits
    assert plan.pages_per_split <= 128  # the kernel's page list
    assert plan.pages_per_split * ps % TILE_KEYS == 0  # splits hold whole tiles
    # every page of the table lies in exactly one split, and no split is
    # wholly past the table
    owners = [[s for s, (lo, hi) in enumerate(_split_ranges(plan, max_pages)) if lo <= p < hi]
              for p in range(max_pages)]
    assert all(len(o) == 1 for o in owners)
    assert all(lo < hi for lo, hi in _split_ranges(plan, max_pages))


def test_decode_plan_takes_shapes_only():
    """The plan's arguments are integers: the wrappers give it B, n_kv, the
    table's width and the page size from shapes (here of tensors on the meta
    device, which hold no values) and the SM count, never a row length."""
    assert all(p.annotation == "int" for p in inspect.signature(_plan_decode).parameters.values())
    q = torch.empty((8, 1, 28, 128), device="meta", dtype=torch.bfloat16)
    pools = torch.empty((28, 4, 257, 128, 128), device="meta", dtype=torch.bfloat16)
    tables = torch.empty((8, 92), device="meta", dtype=torch.int32)
    plan = _plan_decode(q.shape[0], pools.shape[1], tables.shape[1], pools.shape[3])
    assert plan == _plan_decode(8, 4, 92, 128)
    more_sms = _plan_decode(8, 4, 92, 128, n_sm=264)
    assert more_sms.n_splits >= plan.n_splits


@pytest.mark.parametrize("ps", [4, 12, 96, 0])
def test_decode_plan_refuses_page_sizes_off_the_tile(ps):
    with pytest.raises(ValueError, match="_plan_decode"):
        _plan_decode(8, 4, 16, ps)


def _split_combine(q, kp, vp, bt, n_keys, plan, scales=None, staged=None):
    """The kernels' arithmetic in plain float32 torch: per (row, kv head,
    split) the unnormalised partial of the split's keys (softmax over them
    alone: m their max score, l the sum of exp(s - m), acc the p-weighted
    V rows; int8 K scales multiply the scores and V scales the p's), an
    empty partial (l = 0, acc NaN, never read) for a split at or past the
    row's end; merged in split order, with B's staged keys after them as
    partials (s, 1, v), each partial weighted by exp(m - M) where l > 0
    and by 0 where l == 0, as the last block of a row merges them.
    Returns the output and the l of every split."""
    b, _, n_q, hd = q.shape
    n_kv, _, ps, _ = kp.shape
    group, scale, pps = n_q // n_kv, 1.0 / hd ** 0.5, plan.pages_per_split
    out = torch.zeros((b, 1, n_q, hd))
    split_l = {}
    for row in range(b):
        for h in range(n_kv):
            qg = q[row, 0, h * group:(h + 1) * group].float()
            parts = []
            for s in range(plan.n_splits):
                k0, k1 = s * pps * ps, min(int(n_keys[row]), (s + 1) * pps * ps)
                if k0 >= k1:
                    parts.append((torch.full((group,), NEG), torch.zeros(group),
                                  torch.full((group, hd), float("nan"))))
                    split_l[row, h, s] = 0.0
                    continue
                keys = torch.arange(k0, k1)
                pages, slots = bt[row, keys // ps].long(), keys % ps
                k, v = kp[h, pages, slots].float(), vp[h, pages, slots].float()
                sc = qg @ k.T * scale
                pv_mult = torch.ones(len(keys))
                if scales is not None:
                    sc = sc * scales[0][h, pages]
                    pv_mult = scales[1][h, pages]
                m = sc.max(dim=-1).values
                p = torch.exp(sc - m[:, None])
                parts.append((m, p.sum(dim=-1), (p * pv_mult) @ v))
                split_l[row, h, s] = float(p.sum(dim=-1).min())
            if staged is not None:
                sk, sv, staged_len = staged
                for t in range(staged_len):
                    st = qg @ sk[row, h, t].float() * scale
                    parts.append((st, torch.ones(group), sv[row, h, t].float()[None, :].expand(
                        group, hd)))
            m, l, acc = torch.full((group,), NEG), torch.zeros(group), torch.zeros(group, hd)
            for pm, pl_, pacc in parts:
                live = pl_ > 0
                mn = torch.where(live, torch.maximum(m, pm), m)
                a, e = torch.exp(m - mn), torch.where(live, torch.exp(pm - mn), 0.0)
                l = l * a + torch.where(live, pl_ * e, 0.0)
                acc = acc * a[:, None] + torch.where(live[:, None], pacc * e[:, None], 0.0)
                m = mn
            out[row, 0, h * group:(h + 1) * group] = torch.where(
                l[:, None] > 0, acc / torch.where(l > 0, l, 1.0)[:, None], 0.0)
    return out, split_l


NEG = -1e30
SPLIT_PS, SPLIT_MAX_PAGES = 8, 24


def _split_case(seed, lens, group, n_kv=2, hd=32, layers=None, quant=False):
    """Rows over shuffled 8-key pages of a pool with holes (entries past a
    row's pages -1, which nothing may read), rank 4 or, with ``layers``,
    rank 5."""
    rng = np.random.default_rng(seed)
    b, ps, max_pages = len(lens), SPLIT_PS, SPLIT_MAX_PAGES
    num_pages = sum(-(-n // ps) for n in lens) + 7
    lead = (n_kv, num_pages, ps, hd) if layers is None else (layers, n_kv, num_pages, ps, hd)
    q = rng.normal(size=(b, 1, n_kv * group, hd)).astype(np.float32)
    if quant:
        (kp, ks), (vp, vs) = _quant_pages(rng, lead, 8), _quant_pages(rng, lead, 8)
    else:
        kp, vp = (rng.normal(size=lead).astype(np.float32) for _ in range(2))
        ks = vs = None
    perm, at = rng.permutation(num_pages), 0
    bt = np.full((b, max_pages), -1, dtype=np.int32)
    for i, n in enumerate(lens):
        need = -(-n // ps)
        bt[i, :need] = perm[at:at + need]
        at += need
    return q, kp, vp, bt, ks, vs


# rows on (64) and one past (65) a split edge of 64 keys (8 pages of 8),
# one key, none, and one ending mid-split whose later split is empty
SPLIT_LENS = [64, 65, 1, 0, 150]


@pytest.mark.parametrize("group", [2, 7])
def test_split_combine_matches_kernel_f_and_pallas(group):
    q, kp, vp, bt, _, _ = _split_case(5 + group, SPLIT_LENS, group)
    plan = _plan_decode(len(SPLIT_LENS), 2, SPLIT_MAX_PAGES, SPLIT_PS)
    assert plan.pages_per_split * SPLIT_PS == 64 and plan.n_splits == 3
    lens = np.asarray(SPLIT_LENS, np.int32)
    cached, new = np.maximum(lens - 1, 0).astype(np.int32), (lens > 0).astype(np.int32)
    ts = [torch.from_numpy(x) for x in (q, kp, vp, bt, cached, new)]
    emu, split_l = _split_combine(ts[0], ts[1], ts[2], ts[3], lens, plan)
    # splits at or past a row's end add nothing to l, and their (NaN)
    # partials never reach the output
    for (row, _, s), l in split_l.items():
        assert (l == 0.0) == (s * 64 >= SPLIT_LENS[row])
    assert torch.isfinite(emu).all() and not emu[SPLIT_LENS.index(0)].any()
    np.testing.assert_allclose(emu.numpy(), paged_attention_decode_ref(*ts).numpy(),
                               atol=1e-5, rtol=0)
    bt_jax = np.where(bt < 0, 0, bt)  # the Pallas index map reads page 0 past a row's pages
    j_out = np.asarray(j_decode(*(jnp.asarray(x) for x in (q, kp, vp, bt_jax, cached, new)),
                                interpret=True))
    np.testing.assert_allclose(emu.numpy(), j_out, atol=1e-5, rtol=0)


@pytest.mark.parametrize("quant", [False, True])
def test_split_combine_matches_kernel_b_and_pallas(quant):
    """Rank-5 pools read at layer 1, a staged tail of 3 keys, a row whose
    pool prefix is empty (the staged keys alone), int8 pages with their
    scales."""
    L, layer, n_steps, staged_len, group = 3, 1, 4, 3, 7
    q, kp, vp, bt, ks, vs = _split_case(40 + quant, SPLIT_LENS, group, layers=L, quant=quant)
    rng = np.random.default_rng(41)
    sk, sv = (rng.normal(size=(len(SPLIT_LENS), 2, n_steps, 32)).astype(np.float32)
              for _ in range(2))
    plan = _plan_decode(len(SPLIT_LENS), 2, SPLIT_MAX_PAGES, SPLIT_PS)
    pl = np.asarray(SPLIT_LENS, np.int32)
    t = [torch.from_numpy(x) for x in (q, kp, vp, bt, pl, sk, sv)]
    scales = None if not quant else (torch.from_numpy(ks), torch.from_numpy(vs))
    emu, split_l = _split_combine(
        t[0], t[1][layer], t[2][layer], t[3], pl, plan,
        scales=None if scales is None else (scales[0][layer], scales[1][layer]),
        staged=(t[5], t[6], staged_len))
    assert all((l == 0.0) == (s * 64 >= SPLIT_LENS[r]) for (r, _, s), l in split_l.items())
    assert torch.isfinite(emu).all()
    kw = {} if scales is None else dict(k_scales=scales[0], v_scales=scales[1])
    ref = paged_attention_decode_staged_ref(*t, staged_len, layer, **kw)
    np.testing.assert_allclose(emu.numpy(), ref.numpy(), atol=2e-5, rtol=0)
    bt_jax = np.where(bt < 0, 0, bt)
    j_out = np.asarray(j_staged(
        *(jnp.asarray(x) for x in (q, kp, vp, bt_jax, pl, sk, sv)),
        jnp.asarray([staged_len], jnp.int32), jnp.asarray([layer], jnp.int32),
        *(() if not quant else (jnp.asarray(ks), jnp.asarray(vs))), interpret=True))
    np.testing.assert_allclose(emu.numpy(), j_out, atol=2e-5, rtol=0)


# ---- kernels A and C on the card: the prefill plan and its arithmetic -----
#
# bf16 queries run the tensor-core body (csrc/prefill_attention.cuh): flat
# (window position, group member) rows 128 to a block, 64-key stages masked
# only where they reach past the block's first row's bound, the online
# softmax in the log2 domain, P entering both products as bf16 p_hi + p_lo,
# quantized codes widened to bf16 with the K scale on the scores and the V
# scale on p.  f32 queries run the CUDA-core body.  ``_plan_window`` is pure
# Python; the arithmetic is emulated here in plain float32 torch and held to
# the Pallas kernels in interpret mode.

import re  # noqa: E402
from pathlib import Path  # noqa: E402

from githubrepostorag_tpu_torch.ops.fused_decode import (  # noqa: E402
    WINDOW_STAGES,
    WINDOW_TILE_KEYS,
    WINDOW_WIDE_STAGES,
    _plan_window,
)

SMEM_LIMIT = 232448  # a block's shared memory on an H100


@pytest.mark.parametrize("args,want", [
    # the long-context launch: 8 rows x S 128 x group 7 = 7 tiles of 128 rows
    ((8, 128, 28, 4, 128, 128, "wgmma", "fp"), (128, (7, 4, 8), True, 4, 164864)),
    ((8, 128, 28, 4, 128, 128, "wgmma", "int8"), (128, (7, 4, 8), True, 3, 214016)),
    ((4, 512, 28, 4, 128, 128, "wgmma", "int4"), (128, (28, 4, 4), True, 3, 189440)),
    ((3, 5, 4, 2, 64, 8, "wgmma", "fp"), (128, (1, 2, 3), True, 4, 82944)),
    ((3, 5, 4, 2, 64, 8, "fma", "fp"), (64, (1, 2, 3), False, 0, 41728)),
    ((8, 128, 28, 4, 128, 128, "fma", "int8"), (64, (14, 4, 8), False, 0, 74496)),
    ((5, 512, 28, 4, 128, 128, "wgmma", "fp"), (128, (28, 4, 5), True, 4, 164864)),  # C: R, tq
])
def test_window_plan_tiles_flat_rows(args, want):
    b, s, n_q, n_kv, hd, ps, route, pool = args
    plan = _plan_window(b, s, n_q, n_kv, hd, ps, 132, route=route, pool=pool)
    assert (plan.rows_per_block, plan.grid, plan.longest_first, plan.stages,
            plan.smem_bytes) == want
    assert plan.grid[0] * plan.rows_per_block >= (n_q // n_kv) * s  # every flat row tiled
    assert (plan.grid[0] - 1) * plan.rows_per_block < (n_q // n_kv) * s  # no empty tile
    assert plan.waves == pytest.approx(plan.grid[0] * plan.grid[1] * plan.grid[2]
                                       / (132 * plan.blocks_per_sm))


@pytest.mark.parametrize("route", ["wgmma", "fma"])
@pytest.mark.parametrize("pool", ["fp", "int8", "int4"])
@pytest.mark.parametrize("hd", [64, 128])
def test_window_plan_fits_one_block(route, pool, hd):
    """Every branch's shared memory fits a block, and the tensor-core body
    holds one block an SM (512 threads at 128 registers)."""
    plan = _plan_window(4, 512, 28, 4, hd, 128, route=route, pool=pool)
    assert plan.smem_bytes <= SMEM_LIMIT
    assert plan.blocks_per_sm == (1 if route == "wgmma" else min(8, SMEM_LIMIT // plan.smem_bytes))


def test_window_plan_mirrors_the_kernel():
    """The plan's geometry is the kernel's: the constants of
    csrc/prefill_attention.cuh, read from the source."""
    src = (Path(__file__).resolve().parents[1] / "githubrepostorag_tpu_torch" / "csrc"
           / "prefill_attention.cuh").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("KT") == WINDOW_TILE_KEYS
    assert const("ROWS") == _plan_window(1, 1, 1, 1, 64, 64).rows_per_block
    assert const("WIDE_STAGES") == WINDOW_WIDE_STAGES
    quant, fp = re.search(r"STAGES_OF = QUANT \? (\d+) : (\d+);", src).groups()
    assert (int(fp), int(quant)) == (WINDOW_STAGES["fp"], WINDOW_STAGES["int8"])
    assert WINDOW_STAGES["int4"] == WINDOW_STAGES["int8"]
    assert (const("LOADER_WGS") + 2) * 128 == 512


def test_window_plan_takes_shapes_only():
    assert all(p.annotation in ("int", "str")
               for p in inspect.signature(_plan_window).parameters.values())
    q = torch.empty((8, 128, 28, 128), device="meta", dtype=torch.bfloat16)
    pool = torch.empty((4, 521, 128, 128), device="meta", dtype=torch.bfloat16)
    assert _plan_window(q.shape[0], q.shape[1], q.shape[2], pool.shape[0], q.shape[3],
                        pool.shape[2]) == _plan_window(8, 128, 28, 4, 128, 128)


@pytest.mark.parametrize("bad", [
    dict(page_size=4), dict(page_size=12), dict(page_size=96), dict(page_size=0),
    dict(hd=32), dict(hd=96), dict(hd=256), dict(n_q=30), dict(pool="int2"),
    dict(route="mma"), dict(s=0),
])
def test_window_plan_refuses(bad):
    kw = dict(b=4, s=16, n_q=28, n_kv=4, hd=128, page_size=64, route="wgmma", pool="fp")
    kw.update(bad)
    with pytest.raises(ValueError, match="_plan_window"):
        _plan_window(kw["b"], kw["s"], kw["n_q"], kw["n_kv"], kw["hd"], kw["page_size"],
                     route=kw["route"], pool=kw["pool"])


def _widened(pages, quant):
    """Pool pages as the products read them, in float32: bf16 values, or
    int8 codes, or int4 nibble planes sign-extended (component c in byte c's
    low nibble, c + hd / 2 in its high nibble) -- all exact in bf16."""
    if quant == 4:
        x = pages.to(torch.int32)
        return torch.cat([((x & 0xF) ^ 8) - 8, ((x >> 4) ^ 8) - 8], dim=-1).float()
    return pages.float()


def _prefill_tiles(q, kp, vp, bt, cached, new, windows, ks=None, vs=None, quant=0):
    """Kernels A's and C's tensor-core arithmetic in plain float32 torch.
    ``windows[z]`` lists the token (row of q [T, n_q, hd]) of each window
    position of row or segment z.  Per (z, kv head), the flat rows rr =
    t * group + g are cut into 128-row tiles; a tile walks 64-key stages up
    to its last row's causal bound, masking only stages that reach past its
    first row's bound; scores take scale * log2(e) (times the page's K
    scale) and the online softmax runs in the log2 domain; p times the
    page's V scale enters P V as bf16 p_hi + p_lo.  Returns out [T, n_q, hd]
    (0 at tokens no window holds) and the stages walked, and masked."""
    t_all, n_q, hd = q.shape
    n_kv, _, ps, _ = kp.shape
    group, log2e = n_q // n_kv, 1.4426950408889634
    rows, keys = _plan_window(1, 1, n_q, n_kv, hd, ps).rows_per_block, WINDOW_TILE_KEYS
    out = torch.zeros((t_all, n_q, hd))
    walked = masked_stages = 0
    for z, toks in enumerate(windows):
        total = int(cached[z]) + int(new[z])
        rows_total = group * len(toks)
        for h in range(n_kv):
            for r0 in range(0, rows_total, rows):
                rr = torch.arange(r0, min(r0 + rows, rows_total))
                t, g = rr // group, rr % group
                qr = q[torch.as_tensor(toks)[t], h * group + g].float()
                q_pos = int(cached[z]) + t
                kv_end = min(total, int(cached[z]) + int(t[-1]) + 1, bt.shape[1] * ps)
                full_end = min(kv_end, int(cached[z]) + int(t[0]) + 1)
                m = torch.full((len(rr),), NEG)
                l, acc = torch.zeros(len(rr)), torch.zeros((len(rr), hd))
                for k0 in range(0, kv_end, keys):
                    walked += 1
                    pos = torch.arange(k0, min(k0 + keys, kv_end))
                    pages = bt[z, pos // ps].long()
                    k = _widened(kp[h, pages, pos % ps], quant)
                    v = _widened(vp[h, pages, pos % ps], quant)
                    mult = (1.0 / hd ** 0.5) * log2e * (ks[h, pages] if quant else 1.0)
                    x = (qr @ k.T) * mult
                    if k0 + keys > full_end:  # a stage on the diagonal or past total
                        masked_stages += 1
                        ok = pos[None, :] <= q_pos[:, None]
                    else:
                        ok = torch.ones_like(x, dtype=torch.bool)
                    x = torch.where(ok, x, NEG)
                    mn = torch.maximum(m, x.max(dim=1).values)
                    a = torch.exp2(m - mn)
                    p = torch.where(ok, torch.exp2(x - mn[:, None]), 0.0)
                    l = l * a + p.sum(dim=1)
                    pv = p * (vs[h, pages] if quant else 1.0)
                    hi = pv.to(torch.bfloat16).float()
                    lo = (pv - hi).to(torch.bfloat16).float()
                    acc = acc * a[:, None] + hi @ v + lo @ v
                    m = mn
                res = torch.where(l[:, None] > 0, acc / torch.where(l > 0, l, 1.0)[:, None], 0.0)
                out[torch.as_tensor(toks)[t], h * group + g] = res
    return out, walked, masked_stages


def _window_case(seed, b, s_w, n_q, n_kv, hd, ps, cached, new, quant=0):
    """bf16-representable queries and pages (the tensor-core route's
    operands) in float32, shuffled tables over a pool with holes."""
    rng = np.random.default_rng(seed)
    total = [c + n for c, n in zip(cached, new)]
    need = [-(-t // ps) for t in total]
    num_pages, max_pages = sum(need) + 3, max(1, max(need))
    perm, at = rng.permutation(num_pages), 0
    bt = np.zeros((b, max_pages), dtype=np.int32)
    for i, n in enumerate(need):
        bt[i, :n] = perm[at:at + n]
        at += n
    bf = lambda x: torch.from_numpy(x).to(torch.bfloat16).float().numpy()  # noqa: E731
    q = bf(rng.normal(size=(b, s_w, n_q, hd)).astype(np.float32))
    if quant:
        (kp, ks), (vp, vs) = (_quant_pages(rng, (n_kv, num_pages, ps, hd), quant)
                              for _ in range(2))
    else:
        kp, vp = (bf(rng.normal(size=(n_kv, num_pages, ps, hd)).astype(np.float32))
                  for _ in range(2))
        ks = vs = None
    return q, kp, vp, bt, np.asarray(cached, np.int32), np.asarray(new, np.int32), ks, vs


@pytest.mark.parametrize("name,args,stages", [
    # group 7: 259 flat rows over 3 tiles, positions cut mid-tile; cached
    # 100 mid-page (ps 16); a row with total 0 walks nothing
    ("group7_S37", (3, 37, 7, 1, 64, 16, [100, 0, 0], [37, 20, 0]), (11, 7)),
    # group 2: 140 rows over 2 tiles; 8-key pages at hd 64, eight a stage
    ("group2_ps8", (2, 70, 4, 2, 64, 8, [33, 5], [70, 9]), (12, 10)),
])
@pytest.mark.parametrize("quant", [0, 8, 4])
def test_prefill_tiles_match_kernel_a_pallas(name, args, stages, quant):
    b, s_w, n_q, n_kv, hd, ps, cached, new = args
    q, kp, vp, bt, cl, nl, ks, vs = _window_case(len(name) + quant, *args, quant=quant)
    windows = [list(range(z * s_w, (z + 1) * s_w)) for z in range(b)]
    t = [torch.from_numpy(x) for x in (kp, vp, bt)]
    scales = {} if not quant else dict(ks=torch.from_numpy(ks), vs=torch.from_numpy(vs))
    emu, walked, masked = _prefill_tiles(torch.from_numpy(q).reshape(b * s_w, n_q, hd), *t,
                                         cl, nl, windows, quant=quant, **scales)
    assert (walked, masked) == stages  # n_kv * stages walked, and masked, over all tiles
    emu = emu.reshape(b, s_w, n_q, hd)
    for z, (c, n) in enumerate(zip(cached, new)):
        if c + n == 0:  # no valid key: exactly 0, never NaN
            assert not emu[z].any()
    jargs = [jnp.asarray(x) for x in (q, kp, vp, bt, cl, nl)]
    jscales = [] if not quant else [jnp.asarray(ks), jnp.asarray(vs)]
    j_out = np.asarray(j_window(*jargs, *jscales, interpret=True))
    # float32 in another order: the log2-domain exponent, p_hi + p_lo, and
    # for quantized pages the V scale on p (the TPU kernel scales the
    # product), over values up to 127 * scale there: 2e-5 relative too
    tol = dict(atol=2e-5, rtol=2e-5 if quant else 0)
    np.testing.assert_allclose(emu.numpy(), j_out, **tol)
    # and the port's plain version, on CPU tensors
    ref = fused_window_attention_ref(*(torch.from_numpy(x) for x in (q, kp, vp, bt, cl, nl)),
                                     *([] if not quant else [torch.from_numpy(ks),
                                                             torch.from_numpy(vs)]))
    np.testing.assert_allclose(emu.numpy(), ref.numpy(), **tol)


def test_prefill_p_hi_lo_carries_f32():
    """p_hi + p_lo holds p to ~2**-16 of itself; p_hi alone only to ~2**-9."""
    p = torch.rand(4096) * torch.exp2(-torch.randint(0, 20, (4096,)).float())
    hi = p.to(torch.bfloat16).float()
    lo = (p - hi).to(torch.bfloat16).float()
    assert ((hi + lo - p).abs() <= 2 ** -16 * p).all()
    assert ((hi - p).abs() > 2 ** -12 * p).any()
