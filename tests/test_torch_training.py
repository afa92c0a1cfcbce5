"""The port's training path (``githubrepostorag_tpu_torch/training``) against
the JAX package's single-device train step, on the CPU.

Pure Python: the loss against JAX's ``causal_lm_loss`` (optax's integer
cross-entropy), ``adamw`` against ``optax.adamw(1e-4)`` over three
updates, the checkpoint format in one process.  Then one world of 8 gloo
ranks (``tests/torch_parallel_ranks.py``: a group timeout and a join
deadline) runs one train step from the same weights and batch (mask with
zeros: the loss is the global masked mean) on ``MeshPlan()``, tp=4 (KV
replicated: each rank keeps its query head's KV group), sp=4 (the ring)
and dp2·tp2·sp2, and each rank's loss, gradient slices and updated
parameter slices are held against JAX's step on one device:

  - loss within 1e-5 relative;
  - gradients within 1e-5 x max |g| of each leaf;
  - parameters after one AdamW(1e-4, weight decay 1e-4) update within
    1e-6 absolute, save where a gradient within a few eps of 0 lets the
    update's lr / eps sensitivity carry the gradients' own difference
    (one element in 10^4 or so);
  - remat on and off: the same gradients within 1e-7 x max |g| (the
    recompute runs every collective again, on every rank in order);
  - four steps on the full mesh: the loss falls, every value finite;
  - the sharded checkpoint: each rank restores its slices bit for bit; the
    manifest keeps the plan and the specs; the whole tree assembled on
    the CPU holds every rank's slices.
"""

from __future__ import annotations

import json
import socket

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from githubrepostorag_tpu.models.qwen2 import (
    Qwen2Config as JQwen2Config,
    forward_with_attend as j_forward_with_attend,
    init_params as j_init_params,
)
from githubrepostorag_tpu.parallel import MeshPlan as JMeshPlan, make_mesh as j_make_mesh
from githubrepostorag_tpu.training import (
    causal_lm_loss as j_causal_lm_loss,
    make_train_step as j_make_train_step,
)
from githubrepostorag_tpu_torch.models import quant
from githubrepostorag_tpu_torch.models.convert import params_from_jax
from githubrepostorag_tpu_torch.models.qwen2 import Qwen2Config, init_params
from githubrepostorag_tpu_torch.parallel import Mesh, MeshPlan, qwen2_param_specs, shard_params
from githubrepostorag_tpu_torch.parallel.sharding import tree_map
from githubrepostorag_tpu_torch.training import (
    adamw,
    causal_lm_loss,
    init_train_state,
    load_checkpoint,
    make_train_step,
    save_checkpoint,
)
from githubrepostorag_tpu_torch.training.step import leaves
from tests.torch_parallel_ranks import WORLD, random_tree, run_world, training_world

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5  # of the leaf's largest |gradient|
PARAM_ATOL = 1e-6  # after one update of lr 1e-4
# Adam's first update is lr * g / (|g| + eps): where |g| is near eps it
# moves by up to lr / eps times the gradient's own difference
LR, EPS = 1e-4, 1e-8
REMAT_RTOL = 1e-7
PLANS = {"single": {}, "tp4": dict(tp=4), "sp4": dict(sp=4), "full": dict(dp=2, tp=2, sp=2)}


# ------------------------------------------------------------ pure Python --


def test_causal_lm_loss_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 8, 50), dtype=np.float32) * 3
    targets = rng.integers(0, 50, (2, 8), dtype=np.int32)
    mask = (rng.random((2, 8)) > 0.3).astype(np.int32)
    ours = causal_lm_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                          torch.from_numpy(mask))
    theirs = j_causal_lm_loss(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(mask))
    np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-6)
    empty = np.zeros_like(mask)  # the count's floor of 1: zero, not NaN
    assert float(causal_lm_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                                torch.from_numpy(empty))) == 0.0
    assert float(j_causal_lm_loss(jnp.asarray(logits), jnp.asarray(targets),
                                  jnp.asarray(empty))) == 0.0


def test_adamw_matches_optax_adamw():
    """optax.adamw(1e-4): weight decay 1e-4 on every leaf, eps 1e-8; the
    two compute the same update in another order, so two units of float32
    roundoff apart at most."""
    rng = np.random.default_rng(1)
    p0 = rng.standard_normal((5, 7), dtype=np.float32)
    grads = [rng.standard_normal((5, 7), dtype=np.float32) * 10 ** -k for k in range(3)]
    jopt = optax.adamw(1e-4)
    jp, state = jnp.asarray(p0), jopt.init(jnp.asarray(p0))
    tp = torch.from_numpy(p0.copy())
    topt = adamw()([tp])
    for g in grads:
        upd, state = jopt.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        topt.step()
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-7, rtol=2 ** -22)
    assert make_train_step(Qwen2Config.tiny(), None)[1].keywords["weight_decay"] == 1e-4


def test_init_train_state_cuts_tp_slices():
    cfg = Qwen2Config.tiny()
    gen = torch.Generator().manual_seed(0)
    whole = init_params(cfg, gen, "cpu")
    gen.manual_seed(0)
    mesh = Mesh(MeshPlan(tp=4), {"tp": 3})
    state = init_train_state(cfg, mesh, gen, adamw(), device="cpu")
    assert torch.equal(state.params["layers"]["wq"], whole["layers"]["wq"][..., 48:64])
    assert torch.equal(state.params["layers"]["wk"], whole["layers"]["wk"])  # kv replicated
    assert torch.equal(state.params["embed"], whole["embed"][384:512])
    assert state.opt_state.param_groups[0]["params"] == leaves(state.params)


def _equal_trees(a, b) -> bool:
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and torch.equal(x, y)
                                      for x, y in zip(la, lb))


def test_checkpoint_round_trips_a_plain_tree(tmp_path):
    tree = {"w": torch.arange(8, dtype=torch.float32), "step": torch.tensor(3)}
    path = str(tmp_path / "plain")
    save_checkpoint(path, tree)
    out = load_checkpoint(path)
    assert _equal_trees(out, tree) and out["step"].dim() == 0
    assert not (tmp_path / "plain.partial").exists()
    with pytest.raises(FileExistsError):
        save_checkpoint(path, tree, force=False)
    save_checkpoint(path, {"w": torch.ones(2)})  # force: replaced whole
    assert sorted(load_checkpoint(path)) == ["w"]


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_checkpoint_restores_onto_the_template(tmp_path, bits):
    """Plain and quantized trees (NamedTuple leaves rebuilt); the template
    sets dtype and device; a template on another plan is refused."""
    cfg = Qwen2Config.tiny()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    if bits:
        params = quant.quantize_qwen2_params(params, bits=bits, group_size=16)
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, params)
    template = tree_map(torch.zeros_like, params)
    assert _equal_trees(load_checkpoint(path, template), params)
    assert _equal_trees(load_checkpoint(path), params)
    assert type(load_checkpoint(path)["layers"]["wq"]) is type(params["layers"]["wq"])
    if bits is None:
        half = tree_map(lambda t: t.to(torch.bfloat16), params)
        got = load_checkpoint(path, half)
        assert got["layers"]["wq"].dtype == torch.bfloat16
        assert torch.equal(got["layers"]["wq"], half["layers"]["wq"])
    with pytest.raises(ValueError, match="plan"):
        load_checkpoint(path, template, mesh=Mesh(MeshPlan(tp=2)))


# ------------------------------------------------------------ the world ----


def _numpy_tree(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """JAX's single-device step here, the port's on every plan from one
    world of 8 gloo ranks."""
    jcfg = JQwen2Config.tiny()
    # seeded numpy weights in JAX's tree (its shapes by eval_shape)
    shapes = jax.eval_shape(lambda: j_init_params(jcfg, jax.random.PRNGKey(0)))
    params = random_tree(jax.tree.map(lambda x: x.shape, shapes), 0)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, jcfg.vocab_size, (4, 32), dtype=np.int32)
    batch = {"input_ids": ids, "targets": np.roll(ids, -1, axis=1),
             "mask": (rng.random((4, 32)) > 0.25).astype(np.int32)}
    jbatch = jax.tree.map(jnp.asarray, batch)

    def loss_fn(p, b):
        pos = jnp.broadcast_to(jnp.arange(32, dtype=jnp.int32), (4, 32))
        logits = j_forward_with_attend(p, jcfg, b["input_ids"], pos, None, remat=True)
        return j_causal_lm_loss(logits, b["targets"], b["mask"])

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jax.tree.map(jnp.asarray, params),
                                                       jbatch)
    step, opt = j_make_train_step(jcfg, j_make_mesh(JMeshPlan()))
    jp = jax.tree.map(jnp.asarray, params)
    after, _, step_loss = step(jp, opt.init(jp), jbatch)
    ref = {"loss": float(loss), "step_loss": float(step_loss), "grads": _numpy_tree(grads),
           "params": _numpy_tree(after)}

    out = tmp_path_factory.mktemp("training_world")
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{probe.getsockname()[1]}"
    run_world(training_world, (addr, {"params": params, "batch": batch}, str(out)))
    ranks = [torch.load(out / f"{r}.pt") for r in range(WORLD)]
    return {"ref": ref, "params": params, "ranks": ranks, "ckpt": out / "ckpt"}


def _expected(tree_np, res):
    """The slices of a whole (numpy) tree that the rank of ``res`` holds."""
    cfg = Qwen2Config.tiny()
    mesh = Mesh(MeshPlan(**res["plan"]), res["coords"])
    return shard_params(params_from_jax(tree_np, cfg, device="cpu"), mesh,
                        qwen2_param_specs(cfg, mesh))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _cases(world, plan):
    got = [r[plan] for r in world["ranks"] if plan in r]
    assert len(got) == max(1, MeshPlan(**PLANS[plan]).n_devices)
    assert all(r["plan"] == MeshPlan(**PLANS[plan]).shape() for r in got)
    return got


def test_ranks_imported_no_jax(world):
    assert [r["jax_imported"] for r in world["ranks"]] == [False] * WORLD


@pytest.mark.parametrize("plan", PLANS)
def test_step_loss_matches_jax(world, plan):
    for res in _cases(world, plan):
        np.testing.assert_allclose(float(res["loss"]), world["ref"]["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(res["step_loss"]), world["ref"]["step_loss"],
                                   rtol=LOSS_RTOL)


@pytest.mark.parametrize("plan", PLANS)
def test_step_grads_match_jax(world, plan):
    for res in _cases(world, plan):
        want = dict(_flat(_expected(world["ref"]["grads"], res)))
        for name, g in _flat(res["grads"]):
            scale = np.abs(np.asarray(dict(_flat(world["ref"]["grads"]))[name])).max()
            np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=GRAD_RTOL * scale,
                                       rtol=0, err_msg=f"{plan} {res['coords']} {name}")


@pytest.mark.parametrize("plan", PLANS)
def test_step_params_match_jax(world, plan):
    """Within PARAM_ATOL, plus, element by element, the update's
    sensitivity to the gradient's difference (lr / eps per unit: only
    gradients within a few eps of 0 make it count)."""
    for res in _cases(world, plan):
        want = dict(_flat(_expected(world["ref"]["params"], res)))
        jgrad = dict(_flat(_expected(world["ref"]["grads"], res)))
        grads = dict(_flat(res["grads"]))
        for name, p in _flat(res["params"]):
            limit = PARAM_ATOL + LR / EPS * (grads[name] - jgrad[name]).abs()
            diff = (p - want[name]).abs()
            assert bool((diff <= limit).all()), (
                f"{plan} {res['coords']} {name}: {int((diff > limit).sum())} elements, "
                f"max {float(diff.max())}")
            assert int((diff > PARAM_ATOL).sum()) <= max(1, p.numel() // 1000), name


@pytest.mark.parametrize("plan", ["single", "full"])
def test_remat_recompute_keeps_the_gradients(world, plan):
    for res in _cases(world, plan):
        for (name, g), (_, h) in zip(_flat(res["grads"]), _flat(res["grads_no_remat"])):
            np.testing.assert_allclose(g.numpy(), h.numpy(), rtol=0,
                                       atol=REMAT_RTOL * float(h.abs().max()), err_msg=name)


def test_four_steps_on_the_full_mesh_lower_the_loss(world):
    for res in _cases(world, "full"):
        losses = res["losses"]
        assert len(losses) == 4 and all(np.isfinite(losses)), losses
        assert losses[-1] < losses[0], losses
    # every rank reports the same global loss
    assert len({tuple(r["full"]["losses"]) for r in world["ranks"]}) == 1


def test_sharded_checkpoint_round_trips_on_its_plan(world):
    cfg = Qwen2Config.tiny()
    manifest = json.loads((world["ckpt"] / "manifest.json").read_text())
    assert manifest["plan"] == MeshPlan(dp=2, tp=2, sp=2).shape()
    specs = dict(_flat(qwen2_param_specs(cfg, Mesh(MeshPlan(dp=2, tp=2, sp=2)))))
    assert {e["path"]: tuple(e["spec"]) for e in manifest["leaves"]} == specs
    assert sorted(p.name for p in world["ckpt"].iterdir()) == sorted(
        ["manifest.json"] + [f"shard-{i}.safetensors" for i in range(WORLD)])
    whole = load_checkpoint(str(world["ckpt"]))
    for res in world["ranks"]:
        ck = res["checkpoint"]
        assert _equal_trees(ck["restored"], ck["saved"])
        mesh = Mesh(MeshPlan(dp=2, tp=2, sp=2), ck["coords"])
        assert _equal_trees(shard_params(whole, mesh, qwen2_param_specs(cfg, mesh)), ck["saved"])
