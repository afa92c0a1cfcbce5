"""The port's Qwen2-MoE family (``models/moe.py``, the MoE branch of
``models/qwen2.py``, the engine over an MoE tree) against the JAX package
and HF ``Qwen2MoeForCausalLM`` (CPU, float32, the tiny MoE: 4 experts top-2
plus the shared expert).

One HF model built from a ``transformers.Qwen2MoeConfig`` (no download),
its matrices scaled x4 so greedy decoding walks varied tokens and routing
is decided by clear margins, loads into both packages.  Tolerances:
``moe_mlp`` within 1e-5 relative of JAX's with identical drop counts;
logits within 2e-4 of HF (the JAX test's bound) and 1e-5 of JAX's; greedy
engine tokens identical to JAX's engine (and to HF ``generate`` at no
drop).  Quantized expert stacks: the same leaves bit for bit, logits
within 1e-5 of JAX's on those leaves."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from githubrepostorag_tpu.models import moe as j_moe
from githubrepostorag_tpu.models import quant as j_quant
from githubrepostorag_tpu.models.hf_loader import (
    config_from_hf as j_config_from_hf,
    params_from_state_dict as j_params_from_state_dict,
)
from githubrepostorag_tpu.models.qwen2 import forward_with_attend as j_forward_with_attend
from githubrepostorag_tpu.serving import Engine as JEngine, SamplingParams as JSamplingParams
from githubrepostorag_tpu_torch.models import moe
from githubrepostorag_tpu_torch.models import quant
from githubrepostorag_tpu_torch.models.convert import params_from_jax
from githubrepostorag_tpu_torch.models.hf_loader import config_from_hf, params_from_state_dict
from githubrepostorag_tpu_torch.models.qwen2 import (
    Qwen2Config,
    forward_with_attend,
    init_params,
    layer_params,
)
from githubrepostorag_tpu_torch.serving import Engine, SamplingParams

transformers = pytest.importorskip("transformers")

GEOM = dict(max_num_seqs=2, num_pages=64, page_size=8, max_seq_len=128, prefill_chunk=32,
            decode_burst=4)


@pytest.fixture(scope="module")
def tiny_moe():
    """(HF model, JAX numpy tree, port tree, JAX config, port config), at
    capacity 0 (no drop, HF's math)."""
    hf_cfg = transformers.Qwen2MoeConfig(
        vocab_size=512, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=512, rope_theta=10000.0, rms_norm_eps=1e-6,
        tie_word_embeddings=True, attention_dropout=0.0,
        num_experts=4, num_experts_per_tok=2, moe_intermediate_size=48,
        shared_expert_intermediate_size=96, norm_topk_prob=True,
        decoder_sparse_step=1, mlp_only_layers=[], output_router_logits=False)
    torch.manual_seed(0)
    model = transformers.Qwen2MoeForCausalLM(hf_cfg).eval()
    with torch.no_grad():
        for name, w in model.named_parameters():
            if w.dim() >= 2:
                w.mul_(4)
    sd = model.state_dict()
    jcfg = dataclasses.replace(j_config_from_hf(hf_cfg.to_dict()), capacity_factor=0.0)
    cfg = dataclasses.replace(config_from_hf(hf_cfg.to_dict()), capacity_factor=0.0)
    jp = j_params_from_state_dict(sd, jcfg)
    tp = params_from_state_dict(sd, cfg, device="cpu")
    return model, jp, tp, jcfg, cfg


def _at(cfgs, **kw):
    return tuple(dataclasses.replace(c, **kw) for c in cfgs)


def _rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


def test_configs_match_jax(tiny_moe):
    """The MoE fields and presets, field for field; the load default
    capacity is 2.0 on both sides."""
    from githubrepostorag_tpu.models.qwen2 import Qwen2Config as JConfig

    _, _, _, jcfg, cfg = tiny_moe
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for preset in ("tiny_moe", "qwen1_5_moe_a2_7b"):
        assert (dataclasses.asdict(getattr(Qwen2Config, preset)())
                == dataclasses.asdict(getattr(JConfig, preset)()))
    hf = transformers.Qwen2MoeConfig(num_experts=4).to_dict()
    assert config_from_hf(hf).capacity_factor == j_config_from_hf(hf).capacity_factor == 2.0
    assert config_from_hf(hf, moe_capacity_factor=1.5).capacity_factor == 1.5


@pytest.mark.parametrize("bad", [{"mlp_only_layers": [0]}, {"decoder_sparse_step": 2}])
def test_nonuniform_sparsity_refused_as_jax(bad):
    hf = transformers.Qwen2MoeConfig(num_experts=4, **bad).to_dict()
    for parse in (config_from_hf, j_config_from_hf):
        with pytest.raises(ValueError, match="uniform"):
            parse(hf)


def test_state_dict_and_params_from_jax_carry_the_moe_tree(tiny_moe):
    """The port's loader stacks experts [L, E, in, out] as JAX's does, and
    params_from_jax carries JAX's MoE tree across unchanged; a tree whose
    MLP does not match the config is refused."""
    _, jp, tp, _, cfg = tiny_moe
    conv = params_from_jax(jp, cfg, device="cpu")
    assert tp["layers"]["e_wg"].shape == (2, 4, 64, 48)
    for name in jp["layers"]:
        assert torch.equal(tp["layers"][name], conv["layers"][name]), name
    assert torch.equal(tp["embed"], conv["embed"])
    with pytest.raises(ValueError, match="num_experts"):
        params_from_jax(jp, dataclasses.replace(cfg, num_experts=0), device="cpu")


def _biased(jp):
    """Layer 0's leaves with the router biased hard towards expert 0."""
    lay = jax.tree.map(lambda x: x[0], jp["layers"])
    lay = dict(lay, router=lay["router"].copy())
    lay["router"][:, 0] += 100.0
    return lay


@pytest.mark.parametrize("factor,bias", [(0.0, False), (1.5, False), (0.5, True)])
def test_moe_mlp_matches_jax_with_drop_counts(tiny_moe, monkeypatch, factor, bias):
    """One layer's block on the same inputs: outputs within 1e-5 relative
    and the same (assignments, dropped) under MOE_DROP_STATS=1 (none at
    factor 0, where JAX records nothing; many with the router biased
    towards one expert at 0.5)."""
    _, jp, _, jcfg, cfg = tiny_moe
    jcfg, cfg = _at((jcfg, cfg), capacity_factor=factor)
    lay = _biased(jp) if bias else jax.tree.map(lambda x: x[0], jp["layers"])
    x = np.random.default_rng(0).normal(size=(2, 8, cfg.hidden_size)).astype(np.float32)
    monkeypatch.setenv("MOE_DROP_STATS", "1")
    counts = []
    for mod, run in ((j_moe, lambda: np.asarray(jax.block_until_ready(j_moe.moe_mlp(
            jcfg, jax.tree.map(jnp.asarray, lay), jnp.asarray(x))))),
                     (moe, lambda: moe.moe_mlp(
                         cfg, {k: torch.from_numpy(np.asarray(v)) for k, v in lay.items()},
                         torch.from_numpy(x)).numpy())):
        mod.DROP_STATS["assignments"] = mod.DROP_STATS["dropped"] = 0
        counts.append((run(), dict(mod.DROP_STATS)))
    (jy, jstats), (ty, tstats) = counts
    assert _rel(ty, jy) < 1e-5
    assert tstats == jstats
    if factor == 0.0:
        assert tstats == {"assignments": 0, "dropped": 0}
    else:
        assert tstats["assignments"] == 2 * 8 * cfg.num_experts_per_tok
    if bias:
        assert tstats["dropped"] > 0


def test_moe_mlp_ties_go_to_the_lower_index_as_jax(tiny_moe, monkeypatch):
    """A router with equal columns ties every expert for every token: both
    packages take the lower indices, and at capacity 0.5 drop the same
    assignments."""
    _, jp, _, jcfg, cfg = tiny_moe
    jcfg, cfg = _at((jcfg, cfg), capacity_factor=0.5)
    lay = jax.tree.map(lambda x: x[0], jp["layers"])
    lay = dict(lay, router=np.repeat(lay["router"][:, :1], cfg.num_experts, axis=1))
    x = np.random.default_rng(1).normal(size=(1, 6, cfg.hidden_size)).astype(np.float32)
    _, top_i = moe.route(cfg, torch.from_numpy(x[0]), torch.from_numpy(lay["router"]))
    assert top_i.tolist() == [[0, 1]] * 6
    monkeypatch.setenv("MOE_DROP_STATS", "1")
    for mod in (moe, j_moe):
        mod.DROP_STATS["assignments"] = mod.DROP_STATS["dropped"] = 0
    jy = np.asarray(j_moe.moe_mlp(jcfg, jax.tree.map(jnp.asarray, lay), jnp.asarray(x)))
    ty = moe.moe_mlp(cfg, {k: torch.from_numpy(np.asarray(v)) for k, v in lay.items()},
                     torch.from_numpy(x)).numpy()
    assert _rel(ty, jy) < 1e-5
    assert moe.DROP_STATS == j_moe.DROP_STATS == {"assignments": 12, "dropped": 8}


def test_drop_stats_off_records_nothing(tiny_moe, monkeypatch):
    _, jp, _, _, cfg = tiny_moe
    (cfg,) = _at((cfg,), capacity_factor=0.5)
    monkeypatch.delenv("MOE_DROP_STATS", raising=False)
    moe.DROP_STATS["assignments"] = moe.DROP_STATS["dropped"] = 0
    lay = {k: torch.from_numpy(np.asarray(v)) for k, v in _biased(jp).items()}
    moe.moe_mlp(cfg, lay, torch.randn(2, 8, cfg.hidden_size, generator=torch.Generator()
                                      .manual_seed(0)))
    assert moe.DROP_STATS == {"assignments": 0, "dropped": 0}


def test_forward_with_attend_matches_hf_and_jax(tiny_moe):
    model, jp, tp, jcfg, cfg = tiny_moe
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (2, 17), dtype=np.int32)
    pos = np.broadcast_to(np.arange(17, dtype=np.int32), (2, 17)).copy()
    with torch.no_grad():
        ref = model(torch.from_numpy(ids).long()).logits.numpy()
    got = forward_with_attend(tp, cfg, torch.from_numpy(ids), torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    jl = np.asarray(j_forward_with_attend(jax.tree.map(jnp.asarray, jp), jcfg,
                                          jnp.asarray(ids), jnp.asarray(pos)))
    assert _rel(got, jl) < 1e-5


def test_forward_with_attend_remat_keeps_logits_and_gradients(tiny_moe):
    """``remat`` recomputes each layer in backward: the same logits and the
    same gradients as keeping the activations."""
    _, _, tp, _, cfg = tiny_moe
    ids = torch.arange(12)[None] * 7 % cfg.vocab_size
    pos = torch.arange(12)[None]
    grads = []
    for remat in (False, True):
        p = {k: (v.clone().requires_grad_(True) if k == "embed" else v) for k, v in tp.items()}
        logits = forward_with_attend(p, cfg, ids, pos, remat=remat)
        logits.logsumexp(-1).sum().backward()
        grads.append((logits.detach(), p["embed"].grad))
    assert torch.equal(grads[0][0], grads[1][0])
    torch.testing.assert_close(grads[0][1], grads[1][1], rtol=1e-5, atol=1e-7)


def _engines(jp, tp, jcfg, cfg, use_pallas: bool = False, **kw):
    je = JEngine(jax.tree.map(jnp.asarray, jp), jcfg, kv_dtype=jnp.float32,
                 use_pallas=use_pallas, **{**GEOM, **kw})
    te = Engine(tp, cfg, kv_dtype=torch.float32, device="cpu", **{**GEOM, **kw})
    return je, te


def _greedy(prompts, je, te, max_tokens: int):
    jr = je.generate(prompts, JSamplingParams(max_tokens=max_tokens, temperature=0.0,
                                              stop_token_ids=()))
    tr = te.generate(prompts, SamplingParams(max_tokens=max_tokens, temperature=0.0,
                                             stop_token_ids=()))
    return [r.output_tokens for r in jr], [r.output_tokens for r in tr]


def test_engine_greedy_matches_hf_generate_and_jax_at_no_drop(tiny_moe):
    model, jp, tp, jcfg, cfg = tiny_moe
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, 21).tolist()
    je, te = _engines(jp, tp, jcfg, cfg)
    jt, tt = _greedy([prompt], je, te, 12)
    with torch.no_grad():
        hf = model.generate(torch.tensor([prompt]), max_new_tokens=12, do_sample=False,
                            pad_token_id=0, eos_token_id=None, use_cache=True)
    assert tt == jt == [hf[0, len(prompt):].tolist()]
    assert te.prefill_row_floor == 0


@pytest.mark.parametrize("factor", [2.0, 0.5])
def test_engine_greedy_matches_jax_with_idle_rows_and_narrow_waves(tiny_moe, monkeypatch,
                                                                    factor):
    """At the load default 2.0 and at a factor that drops: three requests in
    a bucket of four (an idle row in every decode step) with the width
    ladder on (a narrow second wave).  Capacity counts every dispatched
    token, so the engines must dispatch JAX's rows: the same greedy tokens,
    and under MOE_DROP_STATS=1 the same assignments offered and dropped
    over every dispatch (a padded row would add assignments).  The JAX
    engine runs its attention kernels (interpret mode, as it serves on its
    chip): kernel A gives a wave's empty padding rows 0 there, as the
    port's does, where its plain path averages their masked keys, and a
    padding row's own assignments would then drop differently."""
    _, jp, tp, jcfg, cfg = tiny_moe
    jcfg, cfg = _at((jcfg, cfg), capacity_factor=factor)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (21, 40, 13)]
    monkeypatch.setenv("MOE_DROP_STATS", "1")
    je, te = _engines(jp, tp, jcfg, cfg, max_num_seqs=4, prefill_widths=3, use_pallas=True)
    assert te.prefill_width_buckets == [32, 16]
    for mod in (j_moe, moe):
        mod.DROP_STATS["assignments"] = mod.DROP_STATS["dropped"] = 0
    jt, tt = _greedy(prompts, je, te, 10)
    assert tt == jt
    assert all(len(t) == 10 for t in tt)
    assert moe.DROP_STATS == j_moe.DROP_STATS
    assert (moe.DROP_STATS["dropped"] > 0) == (factor < 1.0)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_expert_stacks_match_jax_and_serve(tiny_moe, monkeypatch, bits):
    """int8 (per expert and output channel) and int4 (group 16) expert and
    shared-expert stacks: the same leaves as JAX's bit for bit, the router
    and the shared gate left full precision, logits within 1e-5 of JAX's
    on those leaves, and the engine serves 8 tokens.  ``INT4_W4A8=0``: the
    JAX package's CPU path never takes W4A8, whose int8 activation codes
    differ from the exact dequant by about 1e-2 (``test_torch_engine.py``)."""
    monkeypatch.setenv("INT4_W4A8", "0")
    _, jp, tp, jcfg, cfg = tiny_moe
    jq = j_quant.quantize_qwen2_params(jp, bits=bits, group_size=16)
    tq = quant.quantize_qwen2_params(tp, bits=bits, group_size=16)
    conv = params_from_jax(jax.tree.map(np.asarray, jq), cfg, device="cpu")
    kind = quant.QuantizedLinear if bits == 8 else quant.QuantizedLinear4
    for name in ("e_wg", "e_wu", "e_wd", "s_wg", "s_wu", "s_wd"):
        leaf = tq["layers"][name]
        assert isinstance(leaf, kind), name
        for a, b in zip(leaf, conv["layers"][name]):
            assert a.dtype == b.dtype and torch.equal(a, b), name
    e = tq["layers"]["e_wg"]
    if bits == 8:
        assert e.s.shape == e.q.shape[:2] + (e.q.shape[-1],)
    else:
        assert e.s.shape == e.zs.shape == (2, 4, 64 // 16, 48)
    assert not isinstance(tq["layers"]["router"], tuple)
    assert not isinstance(tq["layers"]["s_gate"], tuple)
    rng = np.random.default_rng(7)
    ids = rng.integers(0, cfg.vocab_size, (1, 16), dtype=np.int32)
    pos = np.arange(16, dtype=np.int32)[None]
    jl = np.asarray(j_forward_with_attend(jq, jcfg, jnp.asarray(ids), jnp.asarray(pos)))
    tl = forward_with_attend(tq, cfg, torch.from_numpy(ids), torch.from_numpy(pos)).numpy()
    assert _rel(tl, jl) < 1e-5
    eng = Engine(quant.fuse_projections(tq), cfg, kv_dtype=torch.float32, device="cpu", **GEOM)
    res = eng.generate([rng.integers(0, cfg.vocab_size, 15).tolist()],
                       SamplingParams(max_tokens=8, temperature=0.0, stop_token_ids=()))[0]
    assert len(res.output_tokens) == 8 and res.finish_reason == "length"


def test_init_params_draws_the_moe_tree():
    cfg = Qwen2Config.tiny_moe()
    p = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert "wg" not in p["layers"]
    shapes = {k: tuple(v.shape) for k, v in p["layers"].items() if k[:2] in ("e_", "s_")}
    assert shapes == {"e_wg": (2, 4, 64, 48), "e_wu": (2, 4, 64, 48), "e_wd": (2, 4, 48, 64),
                      "s_wg": (2, 64, 96), "s_wu": (2, 64, 96), "s_wd": (2, 96, 64),
                      "s_gate": (2, 64, 1)}
    assert tuple(layer_params(p["layers"], 1)["router"].shape) == (64, 4)
