"""The port's quantized KV pages against the JAX package (CPU): the
``kv_quant`` option's bit width, pool shapes, per-page first-write
quantization, int4 nibble planes, the quantized pool commit and the
dequantizing gather.

Quantization is held bit for bit: the same numpy inputs give the same int8
codes, nibble bytes and float32 scales.  The port's pools and scale pools
carry one page more than the JAX ones (the drop page that padding slots
are written to), so pools and scales compare on ``[..., :P]``.  The gather
dequantizes in float32 on both sides and compares within 2e-5."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from githubrepostorag_tpu.models.qwen2 import Qwen2Config as JConfig
from githubrepostorag_tpu.ops.paged_attention import gather_kv as j_gather_kv
from githubrepostorag_tpu.serving import kv_cache as jkv
from githubrepostorag_tpu_torch.models.qwen2 import Qwen2Config
from githubrepostorag_tpu_torch.ops.paged_attention import gather_kv
from githubrepostorag_tpu_torch.serving import kv_cache as tkv

PS, HD = 4, 16


@pytest.mark.parametrize("value", [None, False, True, 0, 4, 8, "int8", "INT4", "on", "off", ""])
def test_quant_bits_matches_jax(value):
    assert tkv.quant_bits(value) == jkv.quant_bits(value)


def test_quant_bits_rejects_unknown():
    with pytest.raises(ValueError):
        tkv.quant_bits("int3")


@pytest.mark.parametrize("quant", [8, 4])
def test_quantized_pools_have_the_drop_page(quant):
    jp = jkv.make_page_pools(JConfig.tiny(), 16, 8, quant=quant)
    tp = tkv.make_page_pools(Qwen2Config.tiny(), 16, 8, device="cpu", quant=quant)
    for t, j in ((tp.k, jp.k), (tp.v, jp.v), (tp.ks, jp.ks), (tp.vs, jp.vs)):
        assert str(t.dtype)[6:] == str(j.dtype)
        lead = 2 if t.dim() == 5 else t.dim() - 1
        assert t.shape[lead] == j.shape[lead] + 1  # the drop page
        assert t.shape[:lead] + t.shape[lead + 1:] == j.shape[:lead] + j.shape[lead + 1:]
        assert not t.any()
    assert tkv.make_page_pools(Qwen2Config.tiny(), 16, 8, device="cpu").ks is None


def _with_drop(scales: np.ndarray) -> torch.Tensor:
    """JAX [..., P] scales plus the port's drop-page entry."""
    return torch.from_numpy(np.concatenate([scales, np.zeros(scales.shape[:-1] + (1,),
                                                             np.float32)], axis=-1))


@pytest.mark.parametrize("qmax", [127, 7])
def test_quantize_kv_paged_matches_jax_bit_for_bit(qmax):
    """First write opening a page, an append that clips against the stored
    scale, and padding slots, which touch no real page's scale."""
    p = 8
    rng = np.random.default_rng(qmax)
    j_scales = np.zeros((2, p), np.float32)
    t_scales = _with_drop(j_scales)
    # one write shape, so each side compiles or dispatches one program
    writes = [
        (rng.normal(0, 1.0, (2, 6, HD)), [12, 13, 14, 16, 17, -1]),  # opens pages 3, 4
        (rng.normal(0, 10.0, (2, 6, HD)), [15, 18, -1, -1, -1, -1]),  # appends: clip
        (rng.normal(0, 50.0, (2, 6, HD)), [-1] * 6),                  # padding only
    ]
    for vals, slots in writes:
        vals = vals.astype(np.float32)
        slots = np.asarray(slots, np.int32)
        j_slots = np.where(slots < 0, p * PS, slots)  # the JAX callers' sentinel
        jq, js = jkv.quantize_kv_paged(jnp.asarray(vals), jnp.asarray(j_slots),
                                       jnp.asarray(j_scales), PS, qmax=qmax)
        tq, ts = tkv.quantize_kv_paged(torch.from_numpy(vals), torch.from_numpy(slots),
                                       t_scales, PS, qmax=qmax)
        live = slots >= 0
        np.testing.assert_array_equal(tq.numpy()[:, live], np.asarray(jq)[:, live])
        np.testing.assert_array_equal(ts.numpy()[:, :p], np.asarray(js))
        j_scales, t_scales = np.asarray(js), ts
    assert np.abs(tq.numpy()).max() <= qmax
    assert (t_scales[:, 3].numpy() > 0).all() and not t_scales[:, 5:p].any()


def test_pack_int4_matches_jax_and_round_trips():
    rng = np.random.default_rng(1)
    q = rng.integers(-7, 8, (3, 5, HD)).astype(np.int8)
    packed = tkv.pack_int4(torch.from_numpy(q))
    assert packed.dtype == torch.uint8 and packed.shape[-1] == HD // 2
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jkv.pack_int4(jnp.asarray(q))))
    np.testing.assert_array_equal(tkv.unpack_int4(packed).numpy(), q)
    b = rng.integers(0, 256, (4, HD // 2)).astype(np.uint8)
    np.testing.assert_array_equal(tkv.unpack_int4(torch.from_numpy(b)).numpy(),
                                  np.asarray(jkv.unpack_int4(jnp.asarray(b))))


@pytest.mark.parametrize("quant", [8, 4])
def test_commit_paged_matches_jax(quant):
    """Two commits into [L, n_kv, P, ps, hd] pools (a chunk opening pages
    and an append into the same pages), padding slots included: pools and
    scales bit for bit on the real pages."""
    L, n_kv, p = 2, 2, 6
    rng = np.random.default_rng(quant)
    hd_store = HD if quant == 8 else HD // 2
    dtype = np.int8 if quant == 8 else np.uint8
    jk = jnp.zeros((L, n_kv, p, PS, hd_store), dtype)
    js = jnp.zeros((L, n_kv, p), jnp.float32)
    tk = torch.zeros((L, n_kv, p + 1, PS, hd_store), dtype=getattr(torch, np.dtype(dtype).name))
    ts = torch.zeros((L, n_kv, p + 1))
    for slots in ([8, 9, 10, -1, 20, 21], [11, 22, -1, -1, -1, -1]):
        slots = np.asarray(slots, np.int32)
        vals = rng.normal(0, 2.0, (L, n_kv, len(slots), HD)).astype(np.float32)
        jk, js = jkv.commit_paged(jk, jnp.asarray(vals),
                                  jnp.asarray(np.where(slots < 0, p * PS, slots)), js, PS)
        assert tkv.commit_paged(tk, torch.from_numpy(vals), torch.from_numpy(slots), PS,
                                ts) is tk
    np.testing.assert_array_equal(tk[:, :, :p].numpy(), np.asarray(jk))
    np.testing.assert_array_equal(ts[:, :, :p].numpy(), np.asarray(js))
    assert ts[:, :, 2].all() and ts[:, :, 5].all()


@pytest.mark.parametrize("quant", [8, 4])
def test_gather_kv_with_scales_matches_jax(quant):
    n_kv, p = 2, 7
    rng = np.random.default_rng(10 + quant)
    if quant == 8:
        kq = rng.integers(-127, 128, (n_kv, p, PS, HD)).astype(np.int8)
    else:
        kq = rng.integers(0, 256, (n_kv, p, PS, HD // 2)).astype(np.uint8)
    vq = np.flip(kq, axis=1).copy()
    ks = rng.uniform(0.01, 0.1, (n_kv, p)).astype(np.float32)
    vs = rng.uniform(0.01, 0.1, (n_kv, p)).astype(np.float32)
    bt = np.asarray([[4, 0, 6], [2, 5, 1]], np.int32)
    jk, jv = j_gather_kv(*(jnp.asarray(x) for x in (kq, vq, bt, ks, vs)), dtype=jnp.float32)
    tk, tv = gather_kv(*(torch.from_numpy(x) for x in (kq, vq, bt, ks, vs)),
                       dtype=torch.float32)
    assert tk.shape == (2, 3 * PS, n_kv, HD)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=2e-5, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=2e-5, rtol=0)
