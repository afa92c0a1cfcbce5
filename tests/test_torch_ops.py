"""Port primitives vs the JAX package on the same numpy inputs (CPU, f32):
rms_norm, rope, dense_attention, gather_kv / paged_attention_ref and the
pool-commit rule, with block-table holes and -1 padding slots.  Tolerance
1e-5 absolute: the same float32 arithmetic, summed in another order."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from githubrepostorag_tpu.ops import attention as j_att
from githubrepostorag_tpu.ops import norms as j_norms
from githubrepostorag_tpu.ops import paged_attention as j_paged
from githubrepostorag_tpu.ops import rope as j_rope
from githubrepostorag_tpu.serving import kv_cache as j_kv
from githubrepostorag_tpu_torch.ops import attention as t_att
from githubrepostorag_tpu_torch.ops import norms as t_norms
from githubrepostorag_tpu_torch.ops import paged_attention as t_paged
from githubrepostorag_tpu_torch.ops import rope as t_rope
from githubrepostorag_tpu_torch.serving import kv_cache as t_kv

ATOL = 1e-5


def _close(t_out, j_out, atol=ATOL):
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=atol, rtol=0)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    _close(t_norms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           j_norms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))


def test_rope_matches_jax():
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 4000, size=(2, 6)).astype(np.int32)
    q = rng.normal(size=(2, 6, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 6, 2, 16)).astype(np.float32)
    tc, ts = t_rope.rope_cos_sin(torch.from_numpy(pos), 16, 10_000.0)
    jc, js = j_rope.rope_cos_sin(jnp.asarray(pos), 16, 10_000.0)
    _close(tc, jc, 1e-4)  # cos/sin of angles up to ~4000 rad in float32
    _close(ts, js, 1e-4)
    tq, tk = t_rope.apply_rope(torch.from_numpy(q), torch.from_numpy(k), tc, ts)
    jq, jk = j_rope.apply_rope(jnp.asarray(q), jnp.asarray(k), jc, js)
    _close(tq, jq, 5e-4)
    _close(tk, jk, 5e-4)


@pytest.mark.parametrize("causal,offset,lengths,valid", [
    (True, 0, None, False),
    (True, [3, 0], [9, 5], False),
    (False, 0, None, True),
])
def test_dense_attention_matches_jax(causal, offset, lengths, valid):
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 4, 6, 16)).astype(np.float32)  # group 3
    k = rng.normal(size=(2, 9, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 9, 2, 16)).astype(np.float32)
    kv_valid = rng.random((2, 9)) < 0.7 if valid else None
    if kv_valid is not None:
        kv_valid[:, 0] = True
    t_kw = dict(causal=causal,
                q_offset=torch.tensor(offset) if isinstance(offset, list) else offset,
                kv_lengths=None if lengths is None else torch.tensor(lengths),
                kv_valid=None if kv_valid is None else torch.from_numpy(kv_valid))
    j_kw = dict(causal=causal,
                q_offset=jnp.asarray(offset) if isinstance(offset, list) else offset,
                kv_lengths=None if lengths is None else jnp.asarray(lengths),
                kv_valid=None if kv_valid is None else jnp.asarray(kv_valid))
    _close(t_att.dense_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **t_kw),
           j_att.dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **j_kw))


def _paged_case(seed=3):
    """Rows own disjoint shuffled pages (holes in between); row 1 owns the
    pool's LAST page."""
    rng = np.random.default_rng(seed)
    n_kv, num_pages, ps, hd = 2, 12, 4, 16
    k_pages = rng.normal(size=(n_kv, num_pages, ps, hd)).astype(np.float32)
    v_pages = rng.normal(size=(n_kv, num_pages, ps, hd)).astype(np.float32)
    bt = np.asarray([[5, 2, 9, 0], [11, 7, 3, 0], [1, 0, 0, 0]], dtype=np.int32)
    cached = np.asarray([6, 4, 0], dtype=np.int32)
    new = np.asarray([5, 3, 0], dtype=np.int32)
    q = rng.normal(size=(3, 5, 4, hd)).astype(np.float32)
    return q, k_pages, v_pages, bt, cached, new


def test_gather_kv_and_paged_attention_ref_match_jax():
    q, kp, vp, bt, cached, new = _paged_case()
    tk, tv = t_paged.gather_kv(torch.from_numpy(kp), torch.from_numpy(vp), torch.from_numpy(bt))
    jk, jv = j_paged.gather_kv(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt))
    _close(tk, jk, 0)
    _close(tv, jv, 0)
    t_out = t_paged.paged_attention_ref(*(torch.from_numpy(x) for x in (q, kp, vp, bt, cached, new)))
    j_out = j_paged.paged_attention_ref(*(jnp.asarray(x) for x in (q, kp, vp, bt, cached, new)))
    active = [0, 1]  # row 2 has no valid KV: the oracle's output there is unspecified
    _close(t_out[active], np.asarray(j_out)[active])


def test_commit_paged_matches_jax_and_drops_padding():
    rng = np.random.default_rng(4)
    L, n_kv, num_pages, ps, hd = 2, 2, 6, 4, 8
    # the port's pools carry one extra page, the drop page
    pools = rng.normal(size=(L, n_kv, num_pages + 1, ps, hd)).astype(np.float32)
    # a padded chunk whose row owns the pool's last page (slots 20..23):
    # the -1 padding slots must not land on the last slot
    slots = np.asarray([20, 21, 22, -1, -1, 3, 17, -1], dtype=np.int32)
    vals = rng.normal(size=(L, n_kv, len(slots), hd)).astype(np.float32)
    t_pools = torch.from_numpy(pools.copy())
    out = t_kv.commit_paged(t_pools, torch.from_numpy(vals), torch.from_numpy(slots), ps)
    assert out is t_pools  # updated in place
    j_out, _ = j_kv.commit_paged(jnp.asarray(pools[:, :, :num_pages]), jnp.asarray(vals),
                                 jnp.where(jnp.asarray(slots) < 0, num_pages * ps, jnp.asarray(slots)),
                                 None, ps)
    _close(t_pools[:, :, :num_pages], j_out, 0)
    flat = t_pools.view(L, n_kv, (num_pages + 1) * ps, hd)
    np.testing.assert_array_equal(flat[:, :, 23].numpy(), pools.reshape(L, n_kv, -1, hd)[:, :, 23])
    np.testing.assert_array_equal(flat[:, :, 20].numpy(), vals[:, :, 0])


def test_commit_paged_bf16_is_exact():
    rng = np.random.default_rng(5)
    pools = torch.from_numpy(rng.normal(size=(1, 4, 4, 8)).astype(np.float32)).to(torch.bfloat16)
    before = pools.clone()
    vals = torch.from_numpy(rng.normal(size=(1, 3, 8)).astype(np.float32))
    t_kv.commit_paged(pools, vals, torch.tensor([0, -1, 9]), 4)
    flat, ref = pools.view(1, 16, 8), before.view(1, 16, 8).clone()
    ref[0, 0], ref[0, 9] = vals[0, 0].to(torch.bfloat16), vals[0, 2].to(torch.bfloat16)
    assert torch.equal(flat[:, :12], ref[:, :12])  # slots 12.. are the drop page


def test_commit_paged_overwrites_nonfinite_slots():
    # a reused slot holding NaN or inf takes the new value exactly
    pools = torch.full((1, 3, 2, 4), float("nan"))
    pools[0, 1, 0] = float("inf")
    vals = torch.arange(12, dtype=torch.float32).reshape(1, 3, 4)
    t_kv.commit_paged(pools, vals, torch.tensor([2, -1, 0]), 2)
    flat = pools.view(1, 6, 4)
    assert torch.equal(flat[0, 2], vals[0, 0]) and torch.equal(flat[0, 0], vals[0, 2])
    assert flat[0, 1].isnan().all() and flat[0, 3].isnan().all()


def test_allocators_and_slot_mapping_match_jax():
    prompt = list(range(37))
    assert t_kv.page_hashes(prompt, 8) == j_kv.page_hashes(prompt, 8)
    row = np.asarray([4, 1, 7], dtype=np.int32)
    np.testing.assert_array_equal(t_kv.slot_mapping(row, 3, 10, 8, 16),
                                  j_kv.slot_mapping(row, 3, 10, 8, 16))
    assert t_kv.pages_needed(17, 8) == j_kv.pages_needed(17, 8) == 3
    for t_alloc, j_alloc in ((t_kv.PrefixCachingAllocator(8), j_kv.PrefixCachingAllocator(8)),
                             (t_kv.PageAllocator(8), j_kv.PageAllocator(8))):
        hashes = t_kv.page_hashes(prompt, 8)
        for alloc in (t_alloc, j_alloc):
            pages = alloc.allocate(5)
            if hasattr(alloc, "register"):
                for h, p in zip(hashes, pages):
                    alloc.register(h, p)
            alloc.release(pages)
        assert t_alloc.free_count == j_alloc.free_count == 8
        assert t_alloc.can_admit(hashes, 6) == j_alloc.can_admit(hashes, 6)
        if hasattr(t_alloc, "share"):
            assert t_alloc.share(hashes) == j_alloc.share(hashes)
            assert t_alloc.allocate(2) == j_alloc.allocate(2)
