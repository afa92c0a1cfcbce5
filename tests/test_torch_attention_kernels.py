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
