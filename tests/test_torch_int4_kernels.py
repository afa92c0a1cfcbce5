"""The plain versions of the two ported int4 GEMMs against the Pallas TPU
kernel they replace, run in interpret mode on the CPU:

  int4_matmul_ref (kernel D) vs ops/pallas_int4.int4_matmul(w4a8=False)
  w4a8_matmul     (kernel E) vs ops/pallas_int4.int4_matmul(w4a8=True)

Same numpy inputs, float32, group 16.  D: tolerance 1e-5 absolute (the
same dequantized weights summed in another order), and 2e-2 relative
against the two-dot oracle ``q4_matmul``, as the JAX package's own test
holds its kernel.  E: rtol 1e-4, atol 1e-5, the JAX package's own test's
tolerance (the same int8 activations and integer partials; only the f32
summation order differs).  Stacked weights reach the port as one layer's
view; the Pallas kernel takes the stack and a layer index.  On CPU tensors
the wrappers run these plain versions and launch nothing."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from githubrepostorag_tpu.models.quant import QuantizedLinear4 as JQ4
from githubrepostorag_tpu.models.quant import q4_matmul as j_q4_matmul
from githubrepostorag_tpu.models.quant import quantize_weight4 as j_quantize4
from githubrepostorag_tpu.ops.pallas_int4 import int4_matmul as j_int4_matmul
from githubrepostorag_tpu_torch.models.quant import QuantizedLinear4
from githubrepostorag_tpu_torch.ops import int4_matmul as ops

G = 16
IN, OUT, L = 64, 48, 3


@pytest.fixture(scope="module")
def stacked():
    rng = np.random.default_rng(9)
    w = rng.normal(0, 0.02, (L, IN, OUT)).astype(np.float32)
    jw = j_quantize4(w, G)
    return jw, QuantizedLinear4(*(_torch(f) for f in jw))


def _torch(a) -> torch.Tensor:
    a = np.array(a)  # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _layer(tw, li):
    return QuantizedLinear4(*(f[li] for f in tw))


def _pallas(x, jw, li, w4a8, out_dtype=None):
    return np.asarray(j_int4_matmul(jnp.asarray(x), jw.q, jw.s, jw.zs,
                                    layer=jnp.asarray(li, dtype=jnp.int32), out_dtype=out_dtype,
                                    interpret=True, w4a8=w4a8))


@pytest.mark.parametrize("m", [1, 5, 8, 300])
def test_int4_matmul_ref_matches_pallas(stacked, m):
    jw, tw = stacked
    x = np.random.default_rng(m).normal(size=(m, IN)).astype(np.float32)
    for li in (0, 2):
        w = _layer(tw, li)
        got = ops.int4_matmul_ref(torch.from_numpy(x), *w)
        np.testing.assert_allclose(got.numpy(), _pallas(x, jw, li, False), atol=1e-5, rtol=0)
        # the per-layer (unstacked) Pallas call and the wrapper's CPU route agree too
        per = np.asarray(j_int4_matmul(jnp.asarray(x), jw.q[li], jw.s[li], jw.zs[li],
                                       interpret=True, w4a8=False))
        wrapped = ops.int4_matmul(torch.from_numpy(x), *w, w4a8=False)
        np.testing.assert_allclose(wrapped.numpy(), per, atol=1e-5, rtol=0)
        oracle = j_q4_matmul(jnp.asarray(x), JQ4(jw.q[li], jw.s[li], jw.zs[li]))
        np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=2e-2, atol=1e-4)


def test_int4_matmul_ref_3d_batch_f32_out_and_bf16(stacked):
    jw, tw = stacked
    rng = np.random.default_rng(10)
    x = rng.normal(size=(2, 3, IN)).astype(np.float32)
    got = ops.int4_matmul_ref(torch.from_numpy(x), *_layer(tw, 1), out_dtype=torch.float32)
    ref = _pallas(x, jw, 1, False, out_dtype=jnp.float32)
    assert got.shape == (2, 3, OUT) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    # bf16 activations: the dequantized weight is rounded to bf16 at the
    # product and at the difference, as torch rounds `n * s - zs` in bf16
    xb = torch.from_numpy(x).bfloat16()
    w = _layer(tw, 1)
    deq = ops.dequant4(*w, torch.bfloat16)
    assert deq.dtype == torch.bfloat16
    nib = ops.dequant4(w.q, torch.ones_like(w.s), torch.zeros_like(w.zs), torch.float32)
    n_g = w.s.shape[0]
    s_rows = w.s.float().repeat_interleave(IN // n_g, 0)
    z_rows = w.zs.float().repeat_interleave(IN // n_g, 0)
    want = ((nib * s_rows).bfloat16().float() - z_rows).bfloat16()
    assert torch.equal(deq, want)
    out = ops.int4_matmul(xb, *w, out_dtype=torch.float32, w4a8=False)
    np.testing.assert_allclose(out.numpy(), (xb.float().reshape(6, IN) @ deq.float()).reshape(
        2, 3, OUT).numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("m", [1, 5, 8])
def test_w4a8_matches_pallas(stacked, m):
    jw, tw = stacked
    x = np.random.default_rng(20 + m).normal(size=(m, IN)).astype(np.float32)
    for li in (0, 2):
        got = ops.w4a8_matmul(torch.from_numpy(x), *_layer(tw, li))
        np.testing.assert_allclose(got.numpy(), _pallas(x, jw, li, True), rtol=1e-4, atol=1e-5)


def test_w4a8_3d_batch_f32_out_and_zero_row(stacked):
    jw, tw = stacked
    x = np.random.default_rng(12).normal(size=(2, 3, IN)).astype(np.float32)
    x[0, 1] = 0.0  # an all-zero row must not divide by zero
    got = ops.w4a8_matmul(torch.from_numpy(x), *_layer(tw, 2), out_dtype=torch.float32)
    ref = _pallas(x, jw, 2, True, out_dtype=jnp.float32)
    assert got.shape == (2, 3, OUT) and got.dtype == torch.float32
    assert torch.isfinite(got).all() and (got[0, 1] == 0).all()
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)
    # the kernel's plain version alone: the group-scaled integer partials
    w = _layer(tw, 2)
    xq, _ = ops.quantize_rows(torch.from_numpy(x).reshape(6, IN))
    xg = xq.reshape(6, IN // G, G).transpose(0, 1).contiguous()
    acc = ops.w4a8_matmul_ref(xg, w.q, w.s)
    nib = ops.dequant4(w.q, torch.ones_like(w.s), torch.zeros_like(w.zs), torch.float64)
    s_rows = w.s.double().repeat_interleave(G, 0)
    np.testing.assert_allclose(acc.numpy(), (xq.double() @ (nib * s_rows)).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_routing(stacked, monkeypatch):
    """int4_matmul takes W4A8 (kernel E) for at most 256 rows unless
    INT4_W4A8=0 or w4a8=False, and the bf16-dequant route (kernel D)
    otherwise; int4_matmul_plain takes the same route."""
    _, tw = stacked
    w = _layer(tw, 0)
    calls = []
    real = ops.w4a8_matmul
    monkeypatch.setattr(ops, "w4a8_matmul", lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.default_rng(13)
    for rows, env, w4a8, want in [(8, "1", None, True), (256, "1", None, True),
                                  (257, "1", None, False), (8, "0", None, False),
                                  (8, "1", False, False), (300, "0", True, True)]:
        monkeypatch.setenv("INT4_W4A8", env)
        assert ops.takes_w4a8(rows, w4a8) is want
        x = torch.from_numpy(rng.normal(size=(rows, IN)).astype(np.float32))
        calls.clear()
        out = ops.int4_matmul(x, *w, w4a8=w4a8)
        assert bool(calls) is want
        plain = ops.int4_matmul_plain(x, *w, w4a8=w4a8)
        expect = ops._w4a8(x, *w, None, ops.w4a8_matmul_ref) if want else ops.int4_matmul_ref(x, *w)
        assert torch.equal(out, expect) and torch.equal(plain, expect)
    assert ops.int4_matmul.launches == 0 and real.launches == 0  # CPU: no launches
