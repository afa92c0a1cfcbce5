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


# ---------------------------------------------- kernel D's launch plan --
# ``_plan_int4`` is the pure-Python half of kernel D's launch: which loader
# fills the shared-memory ring (TMA or cp.async), how many rows of x a tile
# takes and how many persistent blocks run.  The CUDA kernel itself runs
# only on the card; these hold its preconditions here.

Q7B = {"wqkv": (3584, 4608), "wo": (3584, 3584), "wgu": (3584, 37888), "wd": (18944, 3584),
       "lm_head": (3584, 152064)}
A16 = 1 << 20  # a 16-byte aligned address


@pytest.mark.parametrize("name", sorted(Q7B))
@pytest.mark.parametrize("m", [8, 512, 2048, 4096])
@pytest.mark.parametrize("gsz", [64, 128])
def test_plan_7b_shapes_take_tma(name, m, gsz):
    k, n = Q7B[name]
    plan = ops._plan_int4(m, k, n, gsz, A16, A16, A16, A16)
    assert plan.loader == "tma"
    assert plan.block_m in (8, 64, 128, 256) and (plan.block_m == 8) == (m <= 8)
    assert plan.tiles == -(-n // ops.BLOCK_N) * -(-m // plan.block_m)
    assert plan.grid == min(plan.tiles, 132)


def test_plan_tiles_of_x_rows():
    # the prefill logits run wgmma n8: no padded rows
    assert ops._plan_int4(8, 3584, 152064, 64, A16, A16, A16, A16).block_m == 8
    assert ops._plan_int4(1, 256, 256, 64, A16, A16, A16, A16).block_m == 8
    # a decode-sized batch takes 64 rows, the prefill widths 256
    assert ops._plan_int4(64, 3584, 4608, 64, A16, A16, A16, A16).block_m == 64
    assert ops._plan_int4(4096, 3584, 37888, 64, A16, A16, A16, A16).block_m == 256
    # fewer SMs: the same tiles, a smaller persistent grid
    plan = ops._plan_int4(4096, 3584, 37888, 64, A16, A16, A16, A16, n_sm=16)
    assert plan.grid == 16 and plan.tiles == 296 * 16


@pytest.mark.parametrize("n", [200, 136, 202, 72])
def test_plan_ragged_columns_take_cp_async(n):
    # q rows of N bytes: TMA needs N % 16 == 0
    assert ops._plan_int4(5, 256, n, 64, A16, A16, A16, A16).loader == "cp_async"


@pytest.mark.parametrize("gsz", [16, 32, 48, 256])
def test_plan_groups_off_the_k_step_take_cp_async(gsz):
    k = 768
    assert ops._plan_int4(300, k, 4608, gsz, A16, A16, A16, A16).loader == "cp_async"


@pytest.mark.parametrize("which", [1, 2, 3])
@pytest.mark.parametrize("offset", [4, 8, 12])
def test_plan_weights_off_16_bytes_reroute_to_cp_async(which, offset):
    ptrs = [A16] * 4
    ptrs[which] += offset
    assert ops._plan_int4(4096, 3584, 4608, 64, *ptrs).loader == "cp_async"


@pytest.mark.parametrize("ptrs", [(A16 + 8, A16, A16, A16), (A16 + 4, A16, A16, A16),
                                  (A16, A16 + 2, A16, A16), (A16, A16, A16 + 2, A16),
                                  (A16, A16, A16, A16 + 1)])
def test_plan_refuses_what_no_loader_takes(ptrs):
    # x 16-byte aligned (16-byte copies), q / s / zs 4-byte aligned
    with pytest.raises(ValueError, match="aligned"):
        ops._plan_int4(64, 256, 256, 64, *ptrs)


@pytest.mark.parametrize("k, n, gsz", [(96, 256, 16), (200, 256, 8), (256, 255, 64),
                                       (256, 256, 24), (256, 256, 40), (0, 256, 64)])
def test_plan_refuses_what_the_wrapper_refused(k, n, gsz):
    # K % 64, gsz % 16 (and dividing K), odd N: ValueError as before
    with pytest.raises(ValueError):
        ops._plan_int4(8, k, n, gsz, A16, A16, A16, A16)


def test_loader_counts_start_at_zero_and_cpu_launches_nothing(stacked):
    _, tw = stacked
    x = torch.from_numpy(np.random.default_rng(14).normal(size=(300, IN)).astype(np.float32))
    before = dict(ops.int4_matmul.launches_by_loader)
    ops.int4_matmul(x.bfloat16(), *_layer(tw, 0), w4a8=False)
    assert set(before) == {"tma", "cp_async", "f32"}
    assert ops.int4_matmul.launches_by_loader == before


def _round_bf16(x64: np.ndarray) -> np.ndarray:
    """float64 -> the nearest bf16 (ties to even), exactly, for finite x."""
    m, e = np.frexp(x64)
    return np.ldexp(np.round(np.ldexp(m, 8)), e - 8)


def test_bf16_dequant_arithmetic_rounds_as_dequant4():
    """Kernel D dequantizes in bf16x2 arithmetic, each step rounded once
    (``csrc/int4_matmul.cu``, ``deq2``); dequant4 computes each step in
    f32 and rounds it to bf16.  The two agree when (a) n * s, n in 0..15,
    is exact in f32, so rounding it once to bf16 is the same, and (b) the
    difference of two bf16 values rounds to the same bf16 once as through
    f32.  (a) over every bf16 s of either sign with an exponent in [-120,
    120] (the product stays a normal f32); (b) over every pair of bf16
    values, either sign, with exponents in [-20, 6] (scales, products and
    zero points of real weights lie there)."""
    bits = np.arange(1 << 16, dtype=np.uint32)
    vals = (bits << 16).view(np.float32)
    e = ((bits >> 7) & 0xFF).astype(np.int64) - 127
    scales = vals[(e >= -120) & (e <= 120)].astype(np.float64)
    n = np.arange(16, dtype=np.float64)[:, None]
    prod = n * scales[None, :]
    assert np.array_equal(prod.astype(np.float32).astype(np.float64), prod)

    pos = vals[(bits < 0x8000) & (e >= -20) & (e <= 6)].astype(np.float64)
    both = np.concatenate([pos, -pos, [0.0]])
    zt = torch.from_numpy(both.astype(np.float32)).bfloat16()
    for i in range(0, len(both), 256):
        p = both[i:i + 256, None]
        once = _round_bf16(p - both[None, :])  # exact in float64: exponents span < 40
        twice = (torch.from_numpy(p.astype(np.float32)).bfloat16() - zt[None, :]).double()
        assert np.array_equal(once, twice.numpy())


# ---------------------------------- the W4A8 route and kernel E's plan --
# On the chip the JAX package sends a group to its W4A8 kernel only when
# (gsz // 2) % 32 == 0 (pallas_int4.int4_matmul, the ``not interpret``
# branch); the port's route takes the same rule for CUDA tensors and keeps
# W4A8 at any group for CPU tensors, as interpret mode does.

class _Took(Exception):
    pass


def _jax_route_on_chip(monkeypatch, rows, w, w4a8=None):
    """The kernel ``pallas_int4.int4_matmul`` picks outside interpret mode,
    asked with both of its launches replaced by probes that name
    themselves."""
    from githubrepostorag_tpu.ops import pallas_int4

    def took(name):
        def probe(*args, **kwargs):
            raise _Took(name)
        return probe

    monkeypatch.setattr(pallas_int4, "_w4a8_matmul", took("w4a8"))
    monkeypatch.setattr(pallas_int4.pl, "pallas_call", took("dequant"))
    with pytest.raises(_Took) as probe:
        j_int4_matmul(jnp.zeros((rows, w.q.shape[0] * 2), jnp.float32), w.q, w.s, w.zs,
                      w4a8=w4a8)
    return probe.value.args[0]


@pytest.mark.parametrize("gsz", [16, 32, 48, 64, 128, 256])
@pytest.mark.parametrize("rows,w4a8", [(8, None), (300, None), (8, True)])
def test_w4a8_route_on_the_card_is_the_chips(monkeypatch, gsz, rows, w4a8):
    w = j_quantize4(np.random.default_rng(gsz).normal(0, 0.02, (768, 64)).astype(np.float32),
                    gsz)
    want = _jax_route_on_chip(monkeypatch, rows, w, w4a8) == "w4a8"
    assert want is (rows <= 256 and gsz in (64, 128, 256))
    assert ops.takes_w4a8(rows, w4a8, gsz, on_card=True) is want
    # CPU tensors: W4A8 at any group, as in interpret mode
    assert ops.takes_w4a8(rows, w4a8, gsz) is (rows <= 256 or w4a8 is True)


@pytest.mark.parametrize("gsz", [256, 64])
def test_wide_group_w4a8_matches_pallas(gsz):
    """A group wider than kernel E's 128-byte activation stage (AutoAWQ's
    256) through the route's CPU path, against the Pallas W4A8 kernel in
    interpret mode; the CPU launches nothing."""
    rng = np.random.default_rng(gsz + 1)
    k, n = 1024, 50  # N % 4 == 2: byte loads on the card
    jw = j_quantize4(rng.normal(0, 0.02, (k, n)).astype(np.float32), gsz)
    w = QuantizedLinear4(*(_torch(f) for f in jw))
    x = rng.normal(size=(5, k)).astype(np.float32)
    before = (ops.int4_matmul.launches, ops.w4a8_matmul.launches)
    got = ops.int4_matmul(torch.from_numpy(x), *w)
    ref = np.asarray(j_int4_matmul(jnp.asarray(x), jw.q, jw.s, jw.zs, interpret=True, w4a8=True))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)
    assert (ops.int4_matmul.launches, ops.w4a8_matmul.launches) == before


@pytest.mark.parametrize("k, n, gsz, s_off, general", [
    (1024, 4608, 256, 0, True), (768, 202, 256, 0, True), (512, 202, 64, 0, True),
    (512, 131, 128, 0, True), (3584, 37888, 64, 0, False), (18944, 3584, 128, 0, False),
    (256, 200, 16, 8, False), (3584, 4608, 64, 4, True), (3584, 4608, 64, 12, True)])
def test_w4a8_plan_takes_wide_groups_and_ragged_columns(k, n, gsz, s_off, general):
    # weights 4-byte aligned are enough, as for kernel D; the 7B shapes keep
    # the kernel that stages a whole group with 16-byte copies
    assert ops._plan_w4a8(8, k, n, gsz, A16 + 4, A16 + s_off).general is general


@pytest.mark.parametrize("k, n, gsz, q_off, s_off", [
    (768, 256, 24, 0, 0), (16384 * 2, 256, 16384, 0, 0), (768, 256, 512, 0, 0),
    (768, 256, 64, 2, 0), (768, 256, 64, 0, 2), (768, 0, 64, 0, 0)])
def test_w4a8_plan_refuses_what_kernel_e_cannot_take(k, n, gsz, q_off, s_off):
    with pytest.raises(ValueError, match="w4a8_matmul"):
        ops._plan_w4a8(8, k, n, gsz, A16 + q_off, A16 + s_off)
