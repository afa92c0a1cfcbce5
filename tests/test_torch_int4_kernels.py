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

import re
from pathlib import Path

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


@pytest.mark.parametrize("k, n, gsz, s_off, kernel", [
    (1024, 4608, 256, 0, "mma"), (768, 202, 256, 0, "mma"), (512, 202, 64, 0, "mma"),
    (512, 131, 128, 0, "mma"), (3584, 37888, 64, 0, "mma"), (18944, 3584, 128, 0, "mma"),
    (256, 200, 16, 8, "dp4a"), (3584, 4608, 64, 4, "mma"), (3584, 4608, 64, 12, "mma")])
def test_w4a8_plan_takes_wide_groups_and_ragged_columns(k, n, gsz, s_off, kernel):
    # weights 4-byte aligned are enough, as for kernel D: q, s or zs off 16
    # bytes (or ragged N) take the producer warp's own loads instead of TMA
    plan = ops._plan_w4a8(8, k, n, gsz, A16 + 4, A16 + s_off, A16)
    assert plan.kernel == kernel
    assert plan.loader == ("plain" if kernel == "mma" else "")


@pytest.mark.parametrize("k, n, gsz, q_off, s_off", [
    (768, 256, 24, 0, 0), (16384 * 2, 256, 16384, 0, 0), (768, 256, 512, 0, 0),
    (768, 256, 64, 2, 0), (768, 256, 64, 0, 2), (768, 0, 64, 0, 0)])
def test_w4a8_plan_refuses_what_kernel_e_cannot_take(k, n, gsz, q_off, s_off):
    with pytest.raises(ValueError, match="w4a8_matmul"):
        ops._plan_w4a8(8, k, n, gsz, A16 + q_off, A16 + s_off, A16)


# ------------------------------ kernel E's tensor-core design, on the CPU --
# Kernel E quantizes in a prologue and runs the rest of the route in one
# int8 tensor-core kernel (``csrc/w4a8_matmul.cu``); the CUDA code runs only
# on the card.  These hold its plan, its activation quantization (bit for
# bit), its code layout and fragment mapping, and its arithmetic (a float32
# emulation in its split and merge order) against the JAX route.


@pytest.mark.parametrize("name", sorted(Q7B))
@pytest.mark.parametrize("m", [1, 8, 64, 256])
@pytest.mark.parametrize("gsz", [64, 128, 256])
def test_w4a8_plan_7b_shapes_fill_the_card(name, m, gsz):
    k, n = Q7B[name]
    plan = ops._plan_w4a8(m, k, n, gsz, A16, A16, A16)
    n_g = k // gsz
    assert (plan.kernel, plan.loader) == ("mma", "tma")
    assert plan.grid == (plan.row_blocks, plan.splits, plan.col_tiles)
    tiles = plan.row_blocks * plan.col_tiles
    if ops.W4A8_RESIDENT[plan.block_m] > 1:  # a block for every SM at least
        assert plan.blocks >= 132
    else:  # one block an SM at a time: the most splits that double no SM
        assert plan.splits == max(1, min(n_g, 132 // tiles))
    # the splits partition the groups, none empty
    assert (plan.splits - 1) * plan.groups_per_split < n_g <= plan.splits * plan.groups_per_split
    assert plan.row_blocks * plan.block_m >= m > (plan.row_blocks - 1) * plan.block_m
    assert plan.col_tiles * ops.W4A8_BN >= n
    assert 2 <= plan.stages <= ops.W4A8_MAX_STAGES and plan.smem <= 227 * 1024
    assert plan.groups_per_stage == (min(ops.W4A8_GROUPS_PER_STAGE, plan.groups_per_split)
                                     if gsz == 64 else 1)
    assert plan.stages * ops.w4a8_stage_bytes(plan.block_m, plan.groups_per_stage) + 1024 \
        <= plan.smem
    assert plan.block_m == (8 if m <= 8 else 32)


def _w4a8_kernel_sizes(block_m: int) -> dict:
    """The tensor-core kernel's stage layout and launch rules, read from
    csrc/w4a8_matmul.cu: its constants, ``MmaCfg<BM>``'s sizes (C integer
    expressions, evaluated here), the launcher's shared-memory rule and the
    launch bounds' blocks an SM."""
    src = (Path(__file__).resolve().parents[1] / "githubrepostorag_tpu_torch" / "csrc"
           / "w4a8_matmul.cu").read_text()

    def value(expr: str, env: dict) -> int:
        return int(eval(expr.replace("/", "//"), {}, dict(env)))  # noqa: S307

    env = {"BM": block_m}
    for name in ("BN", "MAX_STAGES", "SMEM_LIMIT", "Q_ROWS"):
        env[name] = value(re.search(rf"constexpr int {name} = ([^;]+);", src).group(1), env)
    cfg = src[src.index("struct MmaCfg {"):src.index("struct MmaParams")]
    for name in ("RT", "X_BYTES", "R_BYTES", "MERGE"):
        env[name] = value(re.search(rf"static constexpr int {name} = ([^;]+);", cfg).group(1), env)
    aux = re.search(r"constexpr int aux\(int G\) \{\s*return ([^;]+);", cfg).group(1)
    assert "const int ring = p.stages * (Q_ROWS * G + C::aux(G));" in src
    pad = re.search(r"const int smem = \(ring > C::MERGE \? ring : C::MERGE\) \+ (\d+);", src)
    bounds = re.search(r"__launch_bounds__\(MMA_THREADS, BM == 8 \? (\d+) : (\d+)\)", src)
    env["aux"] = lambda g: value(aux, {**env, "G": g})
    env["pad"] = int(pad.group(1))
    env["resident"] = int(bounds.group(1) if block_m == 8 else bounds.group(2))
    return env


@pytest.mark.parametrize("name", sorted(Q7B))
@pytest.mark.parametrize("m", [8, 64])
@pytest.mark.parametrize("gsz", [64, 128])
def test_w4a8_plan_mirrors_the_kernel(name, m, gsz):
    """The plan's sizes are the kernel's: the stage and merge bytes, the
    shared memory the launcher asks for (and does not refuse), the ring's
    depth limit, the tile's columns and the blocks an SM."""
    k, n = Q7B[name]
    plan = ops._plan_w4a8(m, k, n, gsz, A16, A16, A16)
    c = _w4a8_kernel_sizes(plan.block_m)
    assert (c["BN"], c["MAX_STAGES"]) == (ops.W4A8_BN, ops.W4A8_MAX_STAGES)
    assert c["resident"] == ops.W4A8_RESIDENT[plan.block_m]
    assert c["MERGE"] == ops.w4a8_merge_bytes(plan.block_m)
    for g in range(1, 9):
        assert c["Q_ROWS"] * g + c["aux"](g) == ops.w4a8_stage_bytes(plan.block_m, g)
    g = plan.groups_per_stage
    ring = plan.stages * (c["Q_ROWS"] * g + c["aux"](g))
    assert plan.smem == max(ring, c["MERGE"]) + c["pad"] <= c["SMEM_LIMIT"] - 1024


@pytest.mark.parametrize("gsz", [16, 32, 48, 64, 128, 192, 256])
@pytest.mark.parametrize("n", [4608, 202, 131])
def test_w4a8_plan_picks_the_kernel_by_group(gsz, n):
    # the tensor cores take every group the card's route sends (k32 steps
    # of whole planes); the CUDA-core kernel the rest; ragged N: own loads
    k = 768 if 768 % gsz == 0 else 3 * gsz
    plan = ops._plan_w4a8(8, k, n, gsz, A16, A16, A16)
    assert plan.kernel == ("mma" if (gsz // 2) % 32 == 0 else "dp4a")
    assert ops.takes_w4a8(8, None, gsz, on_card=True) is (plan.kernel == "mma")
    if plan.kernel == "mma":
        assert plan.loader == ("tma" if n % 16 == 0 else "plain")
    else:
        assert plan.splits == 1 and plan.row_blocks * 8 >= 8


def test_w4a8_counts_start_at_zero_and_cpu_launches_nothing(stacked):
    _, tw = stacked
    x = torch.from_numpy(np.random.default_rng(15).normal(size=(8, IN)).astype(np.float32))
    before = (ops.w4a8_matmul.launches, dict(ops.w4a8_matmul.launches_by_kernel))
    ops.w4a8_matmul(x.bfloat16(), *_layer(tw, 0))
    assert set(before[1]) == {"mma", "dp4a"}
    assert (ops.w4a8_matmul.launches, ops.w4a8_matmul.launches_by_kernel) == before


def _tie_rows(rng, k):
    """Rows whose codes sit on exact .5 ties of x * 127 / amax (amax 127:
    the scale is 1; amax 63.5: it is 2), an all-zero row, a row whose amax
    is below the 1e-30 clamp, and random rows."""
    rows = rng.normal(size=(7, k)).astype(np.float32)
    rows[0] = rng.integers(-126, 126, k) + 0.5
    rows[0, 0] = 127.0
    rows[1] = (rng.integers(-126, 126, k) + 0.5) / 2
    rows[1, 3] = -63.5
    rows[2] = 0.0
    rows[3] *= 1e-31
    rows[4] *= 1e4
    return rows


@pytest.mark.parametrize("gsz", [64, 16])
def test_quantize_rows_bit_for_bit_with_the_jax_route(gsz):
    """quantize_rows and the int32 group sums against the JAX route's own
    expressions (pallas_int4._w4a8_matmul) on the same numpy inputs: the
    codes, sxn and R equal bit for bit, ties and a zero row included, in
    float32 and for bf16 values."""
    k = 256
    x = _tie_rows(np.random.default_rng(gsz), k)
    for xs in (x, torch.from_numpy(x).bfloat16().float().numpy()):
        xf = jnp.asarray(xs)
        amax = jnp.max(jnp.abs(xf), axis=-1, keepdims=True)
        jsxn = amax / 127.0
        jxq = jnp.where(amax > 0, jnp.round(xf * (127.0 / jnp.maximum(amax, 1e-30))), 0.0
                        ).astype(jnp.int8)
        jr = jxq.reshape(len(xs), k // gsz, gsz).sum(axis=-1, dtype=jnp.int32)
        xq, sxn = ops.quantize_rows(torch.from_numpy(xs))
        r = xq.reshape(len(xs), k // gsz, gsz).sum(dim=-1, dtype=torch.int32)
        assert np.array_equal(xq.numpy(), np.asarray(jxq))
        assert np.array_equal(sxn.numpy().view(np.uint32), np.asarray(jsxn).view(np.uint32))
        assert np.array_equal(r.numpy(), np.asarray(jr))
    assert (xq[2] == 0).all() and sxn[2] == 0
    # the ties rounded half to even: 0.5 -> 0, 1.5 -> 2, -2.5 -> -2
    t = torch.tensor([[127.0, 0.5, 1.5, -2.5, 3.5]])
    assert ops.quantize_rows(t)[0].tolist() == [[127, 0, 2, -2, 4]]


def _byte_perm(x: int, y: int, sel: int) -> int:
    b = [(x >> (8 * i)) & 255 for i in range(4)] + [(y >> (8 * i)) & 255 for i in range(4)]
    return sum(b[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))


def _transpose4(rows):  # csrc/w4a8_matmul.cu transpose4, byte for byte
    a_lo, a_hi = _byte_perm(rows[0], rows[1], 0x5140), _byte_perm(rows[0], rows[1], 0x7362)
    b_lo, b_hi = _byte_perm(rows[2], rows[3], 0x5140), _byte_perm(rows[2], rows[3], 0x7362)
    return [_byte_perm(a_lo, b_lo, 0x5410), _byte_perm(a_lo, b_lo, 0x7632),
            _byte_perm(a_hi, b_hi, 0x5410), _byte_perm(a_hi, b_hi, 0x7632)]


def _s8(word: int) -> list[int]:
    return [((word >> (8 * i)) & 255) - (256 if (word >> (8 * i)) & 128 else 0) for i in range(4)]


def _mma_s8(a_regs, b_regs):
    """mma.m16n8k32.s8 as the PTX ISA lays out its fragments: lane (gid,
    tig) holds A[gid | gid+8][4 tig + i (+16)], B[4 tig + i (+16)][gid];
    returns each lane's D {[gid][2tig], [gid][2tig+1], [gid+8][2tig],
    [gid+8][2tig+1]}."""
    a, b = np.zeros((16, 32), np.int64), np.zeros((32, 8), np.int64)
    for lane in range(32):
        gid, tig = lane >> 2, lane & 3
        for reg, (r, c) in enumerate(((gid, 0), (gid + 8, 0), (gid, 16), (gid + 8, 16))):
            a[r, c + 4 * tig:c + 4 * tig + 4] = _s8(a_regs[lane][reg])
        for reg, c in enumerate((0, 16)):
            b[c + 4 * tig:c + 4 * tig + 4, gid] = _s8(b_regs[lane][reg])
    d = a @ b
    return [[d[lane >> 2, 2 * (lane & 3)], d[lane >> 2, 2 * (lane & 3) + 1],
             d[(lane >> 2) + 8, 2 * (lane & 3)], d[(lane >> 2) + 8, 2 * (lane & 3) + 1]]
            for lane in range(32)]


@pytest.mark.parametrize("gsz", [64, 128])
def test_w4a8_mma_fragments_compute_the_group_partials(gsz):
    """The tensor-core kernel's data movement, lane by lane, on one
    32-packed-row stage: the prologue's code layout (its write formula,
    read back by w4a8_prologue_views), the producer's 128-byte-swizzled q
    tile, each consumer thread's loads, transposes and nibble planes, the
    PTX fragment layout of mma.m16n8k32.s8 and the epilogue's (row,
    column) of each D element.  Every (row, column) of the stage gets its
    exact integer partial, for every column group of the tile."""
    rng = np.random.default_rng(gsz + 7)
    bm, m, k = 8, 5, 2 * gsz
    n_g, kps = k // gsz, gsz // 64
    codes = rng.integers(-127, 128, (m, k)).astype(np.int8)
    codes[m - 1] = 0
    # the prologue's writes (w4a8_prologue, MMA branch), one row at a time
    plan = ops.W4A8Plan("mma", "tma", bm, 1, 1, 1, n_g, 1, 2, 0)
    lay = ops._w4a8_layout(plan, k, gsz)
    ws = np.zeros(lay.size, np.uint8)
    for row in range(bm):
        q_row = codes[row] if row < m else np.zeros(k, np.int8)
        for kb in range(k // 32):
            g, kb_g = kb // (2 * kps), kb % (2 * kps)
            to = 2 * (kps * g + kb_g % kps) + kb_g // kps
            run = q_row[32 * kb:32 * kb + 32]
            words = [run[[i, i + 8, i + 16, i + 24]] for i in range(8)]
            off = (to * bm + row) * 32
            ws[off:off + 32] = np.concatenate(words).view(np.uint8)
        sums = q_row.astype(np.int32).reshape(n_g, gsz).sum(-1)
        for g in range(n_g):
            ws[lay.rsum + 4 * (g * bm + row):lay.rsum + 4 * (g * bm + row) + 4] = \
                np.array([sums[g]], np.int32).view(np.uint8)
    xq, _, rsum = ops.w4a8_prologue_views(torch.from_numpy(ws), plan, m, k, gsz)
    assert np.array_equal(xq.numpy(), codes)
    assert np.array_equal(rsum.numpy(), codes.astype(np.int32).reshape(m, n_g, gsz).sum(-1))

    q = rng.integers(0, 256, (k // 2, 128)).astype(np.uint8)
    for g in range(n_g):
        for ch in range(kps):
            stage = (g * kps + ch)
            tile = q[32 * stage:32 * stage + 32]  # packed rows of the stage
            smem = np.zeros(32 * 128, np.uint8)  # TMA's 128-byte swizzle
            for r in range(32):
                for c in range(128):
                    smem[r * 128 + (((c >> 4) ^ (r & 7)) << 4) + (c & 15)] = tile[r, c]
            run = ws[stage * 2 * bm * 32:(stage + 1) * 2 * bm * 32]  # [plane][bm][32]
            # natural codes of the stage: low plane k = g gsz + 32 ch + r,
            # high plane + gsz / 2, for packed row r
            lo_k = g * gsz + 32 * ch + np.arange(32)
            want = (codes[:, lo_k].astype(np.int64) @ (tile & 15).astype(np.int64)
                    + codes[:, lo_k + gsz // 2].astype(np.int64) @ (tile >> 4).astype(np.int64))
            got = np.zeros((bm, 128), np.int64)
            for cg in range(4):
                alo, ahi, bl, bh = [], [], [], []
                for lane in range(32):
                    gid, tig = lane >> 2, lane & 3
                    c4 = 32 * cg + 4 * gid
                    off_e = (((c4 >> 4) ^ (2 * tig)) << 4) | (c4 & 15)
                    off_o = (((c4 >> 4) ^ (2 * tig + 1)) << 4) | (c4 & 15)

                    def word(at):
                        return int(smem[at:at + 4].view(np.uint32)[0])

                    te = _transpose4([word((2 * tig + 8 * u) * 128 + off_e) for u in range(4)])
                    to_ = _transpose4([word((2 * tig + 1 + 8 * u) * 128 + off_o) for u in range(4)])
                    nib = 0x0F0F0F0F
                    alo.append([[te[2 * t] & nib, te[2 * t + 1] & nib, to_[2 * t] & nib,
                                 to_[2 * t + 1] & nib] for t in range(2)])
                    ahi.append([[(te[2 * t] >> 4) & nib, (te[2 * t + 1] >> 4) & nib,
                                 (to_[2 * t] >> 4) & nib, (to_[2 * t + 1] >> 4) & nib]
                                for t in range(2)])
                    xs = gid * 32 + tig * 8
                    bl.append(run[xs:xs + 8].view(np.uint32).tolist())
                    bh.append(run[bm * 32 + xs:bm * 32 + xs + 8].view(np.uint32).tolist())
                for t in range(2):
                    d = np.array(_mma_s8([a[t] for a in alo], bl)) + np.array(
                        _mma_s8([a[t] for a in ahi], bh))
                    for lane in range(32):
                        gid, tig = lane >> 2, lane & 3
                        for e in range(4):  # {col 2t, row 0}, {2t, 1}, {2t+1, 0}, {2t+1, 1}
                            got[2 * tig + (e & 1), 32 * cg + 4 * gid + 2 * t + (e >> 1)] = d[lane][e]
            assert np.array_equal(got[:m], want)


def _emulate_kernel_e(x, w, plan, out_dtype):
    """Kernel E's arithmetic in float32 numpy, in its order: per block
    (split), parity p takes every other ring stage of G groups (its groups
    g with (g - g0) // G % 2 == p, in order; G = ``groups_per_stage``); each group
    adds fl(float(P) * s) to acc and fl(float(R) * zs) to zacc, P the exact
    int32 partial; the block is parity 0 + parity 1; with splits the tile's
    last block sums the splits in split order from 0; y = fl(sxn * fl(acc -
    zacc)), rounded once to ``out_dtype``."""
    m, k = x.shape
    gsz = k // w.s.shape[0]
    xq, sxn = ops.quantize_rows(torch.from_numpy(x))
    xq, sxn = xq.numpy().astype(np.int64), sxn.numpy()
    nib = ops.dequant4(w.q, torch.ones_like(w.s), torch.zeros_like(w.zs), torch.float64
                       ).numpy().astype(np.int64)
    s, zs = w.s.float().numpy(), w.zs.float().numpy()
    n = s.shape[1]
    total_acc, total_z = np.zeros((m, n), np.float32), np.zeros((m, n), np.float32)
    for sp in range(plan.splits):
        g0 = sp * plan.groups_per_split
        groups = range(g0, min(g0 + plan.groups_per_split, s.shape[0]))
        par = []
        for p in (0, 1):
            acc, z = np.zeros((m, n), np.float32), np.zeros((m, n), np.float32)
            for g in (g for g in groups if (g - g0) // plan.groups_per_stage % 2 == p):
                part = xq[:, g * gsz:(g + 1) * gsz] @ nib[g * gsz:(g + 1) * gsz]
                r = xq[:, g * gsz:(g + 1) * gsz].sum(-1, keepdims=True)
                acc = acc + part.astype(np.float32) * s[g]
                z = z + r.astype(np.float32) * zs[g]
            par.append((acc, z))
        block_acc, block_z = par[0][0] + par[1][0], par[0][1] + par[1][1]
        if plan.splits == 1:
            total_acc, total_z = block_acc, block_z
        else:
            total_acc, total_z = total_acc + block_acc, total_z + block_z
    y = torch.from_numpy(sxn * (total_acc - total_z))
    return y.to(out_dtype)


@pytest.mark.parametrize("gsz, n_sm", [(64, 6), (128, 6), (64, 132)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_kernel_e_arithmetic_matches_jax_and_the_plain_route(gsz, n_sm, out_dtype):
    """A float32 emulation of kernel E's arithmetic, at a size where the
    plan splits K (3 or 8 splits, both parities busy, a ragged last
    split) and the second column tile is ragged (N = 200): against the
    JAX route (the Pallas W4A8 kernel in interpret mode), rtol 1e-4 and
    atol 1e-5 as the JAX package's own test; against the port's plain
    route within 1e-5 relative of each element's sum of |group terms|
    (f32 sums in another order; bf16 out: one bf16 ulp more)."""
    rng = np.random.default_rng(gsz + n_sm)
    k, n, m = 1024, 200, 5
    jw = j_quantize4(rng.normal(0, 0.02, (k, n)).astype(np.float32), gsz)
    w = QuantizedLinear4(*(_torch(f) for f in jw))
    x = rng.normal(size=(m, k)).astype(np.float32)
    x[2] = 0.0
    plan = ops._plan_w4a8(m, k, n, gsz, A16, A16, A16, n_sm=n_sm)
    assert plan.kernel == "mma" and plan.col_tiles == 2 and plan.splits > 1
    assert plan.groups_per_split >= 2 and (k // gsz) % plan.groups_per_split != 0 or n_sm == 132
    got = _emulate_kernel_e(x, w, plan, out_dtype)
    jref = np.asarray(j_int4_matmul(jnp.asarray(x), jw.q, jw.s, jw.zs, interpret=True, w4a8=True,
                                    out_dtype=jnp.float32))
    plain = ops._w4a8(torch.from_numpy(x), *w, out_dtype, ops.w4a8_matmul_ref)
    assert (got[2] == 0).all()
    np.testing.assert_allclose(got.float().numpy(), jref, rtol=1e-4 if out_dtype == torch.float32
                               else 2 ** -7, atol=1e-5)
    xq, sxn = ops.quantize_rows(torch.from_numpy(x))
    terms = _group_terms(xq, sxn, w, gsz)
    bf16_ulp = 2 ** -7 * plain.float().abs() if out_dtype == torch.bfloat16 else 0
    assert ((got.float() - plain.float()).abs() <= 1e-5 * terms + bf16_ulp + 1e-30).all()


def _group_terms(xq, sxn, w, gsz):
    """sxn * sum_g (|s P| + |R zs|): the magnitudes the route adds."""
    m, k = xq.shape
    xg = xq.reshape(m, k // gsz, gsz).transpose(0, 1).float()
    pg = w.q.reshape(k // gsz, gsz // 2, -1)
    nib = torch.cat([pg & 0xF, pg >> 4], dim=1).float()
    p = (torch.bmm(xg, nib).abs() * w.s.float()[:, None, :]).sum(0)
    r = xq.reshape(m, k // gsz, gsz).sum(-1).float().abs() @ w.zs.float().abs()
    return sxn * (p + r)
