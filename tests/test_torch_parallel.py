"""The port's parallel fabric (``githubrepostorag_tpu_torch/parallel``)
against the JAX package's, on the CPU.

Pure Python: the mesh plan and its parsers, the one-device mesh without
``torch.distributed``, the sharding specs leaf for leaf (tp 2 and 4,
quantized leaves, experts over ep), the environment contract of
``maybe_initialize_distributed`` (a one-process gloo world in a
subprocess).  Then one world of 8 gloo ranks (``tests/torch_parallel_ranks.py``:
a group timeout and a join deadline, so a deadlock fails) runs every
multi-rank case, and each is held against JAX's values computed here on
the 8-device virtual CPU mesh (conftest) from the same seeded numpy
inputs:

  - ring attention at sp=4 and dp2·tp2·sp2 against JAX's
    ``make_ring_attend``: atol 1e-5 (JAX's own ring-vs-dense bound);
  - its q / k / v gradients (the reverse ring through ``ppermute``)
    against JAX's dense gradients: 1e-5 x max |g|;
  - the segmented ring's output against JAX's, as above;
  - the collectives' forward and backward, exactly;
  - a dp4·tp2 sharded forward against the unsharded one (1e-6 x max
    |logit|) and against JAX's logits (1e-5 x max |logit|).
"""

from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from githubrepostorag_tpu.models import quant as j_quant
from githubrepostorag_tpu.models.qwen2 import (
    Qwen2Config as JQwen2Config,
    forward_with_attend as j_forward_with_attend,
    init_params as j_init_params,
)
from githubrepostorag_tpu.ops.attention import dense_attention as j_dense_attention
from githubrepostorag_tpu.parallel import (
    MeshPlan as JMeshPlan,
    make_mesh as j_make_mesh,
    make_ring_attend as j_make_ring_attend,
    plan_for_devices as j_plan_for_devices,
    plan_from_string as j_plan_from_string,
    qwen2_param_specs as j_qwen2_param_specs,
)
from githubrepostorag_tpu_torch.models import quant
from githubrepostorag_tpu_torch.models.convert import params_from_jax
from githubrepostorag_tpu_torch.models.qwen2 import Qwen2Config
from githubrepostorag_tpu_torch.parallel import (
    AXIS_NAMES,
    Mesh,
    MeshPlan,
    make_mesh,
    maybe_initialize_distributed,
    plan_for_devices,
    plan_from_string,
    qwen2_param_specs,
)
from githubrepostorag_tpu_torch.parallel.collectives import (
    copy_to_axis,
    gather_from_axis,
    ppermute,
    reduce_from_axis,
)
from githubrepostorag_tpu_torch.parallel.sharding import shard_tensor
from tests.torch_parallel_ranks import QKV_SPEC, WORLD, parallel_world, random_tree, run_world

RING_ATOL = 1e-5
GRAD_RTOL = 1e-5  # of the largest |gradient| of the tensor
LOGIT_RTOL_PORT = 1e-6  # sharded vs unsharded port forward, of max |logit|
LOGIT_RTOL_JAX = 1e-5  # port vs JAX forward, of max |logit|

# ----------------------------------------------------------------- mesh ----


def test_mesh_axes_and_size_match_jax():
    plan = MeshPlan(dp=2, tp=2, sp=2)
    jm = j_make_mesh(JMeshPlan(dp=2, tp=2, sp=2))
    mesh = Mesh(plan)
    assert mesh.axis_names == AXIS_NAMES == tuple(jm.axis_names)
    assert mesh.shape == dict(jm.shape)
    assert plan.n_devices == 8 and mesh.index == 0


@pytest.mark.parametrize("spec", ["dp:2,tp:4", "tp:4, sp:2", "", "ep:2,pp:1,dp:3"])
def test_plan_from_string_matches_jax(spec):
    assert plan_from_string(spec).shape() == j_plan_from_string(spec).shape()


@pytest.mark.parametrize("spec,match", [("tp:0", "MESH_SHAPE"), ("xx:2", "MESH_SHAPE"),
                                        ("tp:4,tp:2", "twice")])
def test_plan_from_string_errors_match_jax(spec, match):
    with pytest.raises(ValueError, match=match) as ours:
        plan_from_string(spec)
    with pytest.raises(ValueError) as theirs:
        j_plan_from_string(spec)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("n,kw", [
    (8, dict(num_heads=14, num_kv_heads=2, role="serve")),
    (8, dict(num_heads=28, num_kv_heads=4, role="serve")),
    (8, dict(num_heads=4, num_kv_heads=2, role="serve")),
    (8, dict(role="ingest")),
    (8, dict(num_heads=4, num_kv_heads=2, role="train")),
    (16, dict(num_heads=14, num_kv_heads=2, role="train")),
    (6, dict(role="train")),
])
def test_plan_for_devices_matches_jax(n, kw):
    assert plan_for_devices(n, **kw).shape() == j_plan_for_devices(n, **kw).shape()


def test_plan_for_devices_refusals():
    with pytest.raises(ValueError):
        plan_for_devices(0)
    with pytest.raises(ValueError, match="unknown role"):
        plan_for_devices(4, role="bogus")


def test_mesh_too_many_devices_raises():
    """Without torch.distributed the world is this one process."""
    with pytest.raises(ValueError, match="needs 16 devices"):
        make_mesh(MeshPlan(dp=16))
    with pytest.raises(ValueError):
        make_mesh(MeshPlan(tp=2))
    with pytest.raises(TypeError):
        make_mesh(MeshPlan(), dp=1)


def test_one_device_mesh_needs_no_distributed():
    assert not torch.distributed.is_initialized()
    mesh = make_mesh(MeshPlan())
    assert mesh.coords == dict.fromkeys(AXIS_NAMES, 0) and mesh.groups == {}
    assert make_mesh(dp=1).plan == MeshPlan()
    mesh.barrier()  # no group: nothing to wait for
    with pytest.raises(ValueError, match="outside"):
        Mesh(MeshPlan(tp=2), {"tp": 2})


def test_collectives_without_a_group_are_the_identity():
    x = torch.arange(6.0, requires_grad=True)
    for y in (ppermute(x, None, [(0, 0)]), copy_to_axis(x, None), reduce_from_axis(x, None),
              gather_from_axis(x, None, 0)):
        assert y is x


# ------------------------------------------------------------- sharding ----


def _norm_spec(spec):
    """A spec leaf of either package as plain data: NamedTuples by type
    name and fields, PartitionSpecs and tuples as tuples."""
    if hasattr(spec, "_fields"):
        return (type(spec).__name__, tuple(_norm_spec(f) for f in spec))
    return tuple(spec)


def _norm_tree(tree):
    if isinstance(tree, dict):
        return {k: _norm_tree(v) for k, v in tree.items()}
    return _norm_spec(tree)


@pytest.mark.parametrize("preset", ["tiny", "tiny_moe", "untied"])
@pytest.mark.parametrize("bits", [None, 8, 4])
@pytest.mark.parametrize("plan", [dict(tp=2), dict(tp=4), dict(dp=2, tp=2, sp=2),
                                  dict(tp=2, ep=2)])
def test_qwen2_specs_match_jax_leaf_for_leaf(preset, bits, plan):
    """Plain, int8 and int4 trees (the port's quantizer on the port's
    weights, JAX's on JAX's), tied and untied, dense and MoE."""
    if preset == "untied":
        cfg, jcfg = (dataclasses.replace(c.tiny(), tie_word_embeddings=False)
                     for c in (Qwen2Config, JQwen2Config))
    else:
        cfg, jcfg = getattr(Qwen2Config, preset)(), getattr(JQwen2Config, preset)()
    jp = jax_shaped_tree(jcfg, 0)
    tp = params_from_jax(jp, cfg, device="cpu")
    if bits is not None:
        tp = quant.quantize_qwen2_params(tp, bits=bits, group_size=16)
    ours = qwen2_param_specs(cfg, Mesh(MeshPlan(**plan)), None if bits is None else tp)
    jq = None if bits is None else j_quant.quantize_qwen2_params(
        jax.tree.map(jnp.asarray, jp), bits=bits, group_size=16)
    theirs = j_qwen2_param_specs(jcfg, j_make_mesh(JMeshPlan(**plan)), jq)
    assert _norm_tree(ours) == _norm_tree(theirs)


def test_kv_replicated_when_tp_exceeds_kv_heads():
    specs = qwen2_param_specs(Qwen2Config.tiny(), Mesh(MeshPlan(tp=4)))
    assert specs["layers"]["wk"] == (None, None, None)
    assert specs["layers"]["wq"] == (None, None, "tp")
    assert specs["embed"] == ("tp", None)


def test_shard_tensor_cuts_contiguous_slices():
    x = torch.arange(4 * 6).reshape(4, 6)
    mesh = Mesh(MeshPlan(dp=2, tp=3), {"dp": 1, "tp": 2})
    assert torch.equal(shard_tensor(x, mesh, ("dp", "tp")), x[2:4, 4:6])
    with pytest.raises(ValueError, match="does not split"):
        shard_tensor(x, Mesh(MeshPlan(tp=4)), (None, "tp"))


# ---------------------------------------------------- distributed runtime ----


def test_maybe_initialize_distributed_is_a_noop_without_env(monkeypatch):
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.delenv("JAX_DISTRIBUTED", raising=False)
    assert maybe_initialize_distributed() is False
    assert not torch.distributed.is_initialized()


def _free_port() -> int:
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def test_single_process_runtime_initializes_once():
    """A one-process gloo world from JAX's variables (in a subprocess, so
    this process stays outside any world), idempotent, with the mesh's
    groups over it; a coordinator without the world size is refused."""
    env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{_free_port()}",
               JAX_NUM_PROCESSES="1", JAX_PROCESS_ID="0")
    code = (
        "import torch.distributed as dist\n"
        "from githubrepostorag_tpu_torch.parallel import maybe_initialize_distributed, make_mesh\n"
        "assert maybe_initialize_distributed(device='cpu', timeout_s=30) is True\n"
        "assert maybe_initialize_distributed(device='cpu') is True  # idempotent\n"
        "assert dist.get_world_size() == 1 and dist.get_backend() == 'gloo'\n"
        "mesh = make_mesh(dp=1)\n"
        "assert sorted(mesh.groups) == sorted(mesh.axis_names)\n"
        "print('DIST OK')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120, cwd=root)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "DIST OK" in proc.stdout
    del env["JAX_NUM_PROCESSES"]
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120, cwd=root)
    assert proc.returncode != 0 and "JAX_NUM_PROCESSES" in proc.stderr


# ------------------------------------------------------------ the world ----


def jax_shaped_tree(jcfg, seed: int) -> dict:
    """Seeded numpy weights in the tree JAX's ``init_params`` builds (its
    shapes by ``jax.eval_shape``: nothing compiled)."""
    shapes = jax.eval_shape(lambda: j_init_params(jcfg, jax.random.PRNGKey(0)))
    return random_tree(jax.tree.map(lambda x: x.shape, shapes), seed)


def _qkv(seed, b, s, nq, nkv, hd):
    rng = np.random.default_rng(seed)
    return {"q": rng.standard_normal((b, s, nq, hd), dtype=np.float32),
            "k": rng.standard_normal((b, s, nkv, hd), dtype=np.float32),
            "v": rng.standard_normal((b, s, nkv, hd), dtype=np.float32)}


def _grads(fn, qkv):
    args = [jnp.asarray(qkv[n]) for n in ("q", "k", "v")]
    g = jax.jit(jax.grad(lambda q, k, v: (fn(q, k, v) ** 2).sum(), argnums=(0, 1, 2)))(*args)
    return {f"d{n}": np.asarray(x) for n, x in zip("qkv", g)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """JAX's values here, the port's from one world of 8 gloo ranks."""
    ring = _qkv(0, 4, 64, 4, 2, 16)
    grad = _qkv(1, 2, 32, 4, 2, 8)
    # packed segments: sorted ids, several sequences to a row
    seg = np.sort(np.random.default_rng(2).integers(0, 5, (4, 64)), axis=1).astype(np.int32)
    jcfg = JQwen2Config.tiny()
    jp = jax_shaped_tree(jcfg, 0)
    ids = np.random.default_rng(3).integers(0, jcfg.vocab_size, (4, 16), dtype=np.int32)

    j_ring = {n: j_make_ring_attend(j_make_mesh(JMeshPlan(**plan)), num_heads=4, num_kv_heads=2)
              for n, plan in (("sp4", dict(sp=4)), ("full", dict(dp=2, tp=2, sp=2)))}
    j_seg = j_make_ring_attend(j_make_mesh(JMeshPlan(sp=4)), num_heads=4, num_kv_heads=2,
                               segmented=True)
    jseg = jnp.asarray(seg)
    pos = jnp.broadcast_to(jnp.arange(16, dtype=jnp.int32), (4, 16))
    ref = {
        "ring": {n: np.asarray(jax.jit(f)(*(jnp.asarray(ring[x]) for x in "qkv")))
                 for n, f in j_ring.items()},
        "dense_grads": _grads(lambda q, k, v: j_dense_attention(q, k, v, causal=True), grad),
        "seg": np.asarray(jax.jit(j_seg)(*(jnp.asarray(ring[x]) for x in "qkv"), jseg)),
        "logits": np.asarray(jax.jit(lambda p: j_forward_with_attend(
            p, jcfg, jnp.asarray(ids), pos))(jax.tree.map(jnp.asarray, jp))),
    }
    out = tmp_path_factory.mktemp("parallel_world")
    refs = {"ring": ring, "grad": grad, "seg": seg, "model": {"params": jp, "ids": ids}}
    run_world(parallel_world, (f"127.0.0.1:{_free_port()}", refs, str(out)))
    ranks = [torch.load(out / f"{r}.pt") for r in range(WORLD)]
    return {"ref": ref, "inputs": refs, "ranks": ranks}


def _slice(x: np.ndarray, res: dict, spec=QKV_SPEC) -> torch.Tensor:
    return shard_tensor(torch.from_numpy(np.array(x)), Mesh(MeshPlan(**res["plan"]),
                                                            res["coords"]), spec)


def _cases(world, key):
    got = [r[key] for r in world["ranks"] if key in r]
    assert got, key
    return got


def test_ranks_imported_no_jax(world):
    assert [r["jax_imported"] for r in world["ranks"]] == [False] * WORLD


def test_rank_coords_follow_jax_device_grid(world):
    """Rank r sits where device r sits in JAX's mesh of the same plan."""
    jm = j_make_mesh(JMeshPlan(dp=2, tp=2, sp=2))
    for rank, res in enumerate(world["ranks"]):
        coords = res["ring_full"]["coords"]
        assert jm.devices[tuple(coords[a] for a in AXIS_NAMES)].id == rank


@pytest.mark.parametrize("plan", ["sp4", "full"])
def test_ring_attention_matches_jax(world, plan):
    ref = world["ref"]["ring"][plan]
    for res in _cases(world, f"ring_{plan}"):
        np.testing.assert_allclose(res["out"].numpy(), _slice(ref, res).numpy(),
                                   atol=RING_ATOL, rtol=0)


@pytest.mark.parametrize("plan", ["sp4", "full"])
def test_ring_attention_grads_match_jax_dense(world, plan):
    ref = world["ref"]["dense_grads"]
    for res in _cases(world, f"ring_{plan}_grads"):
        for name in ("dq", "dk", "dv"):
            np.testing.assert_allclose(res[name].numpy(), _slice(ref[name], res).numpy(),
                                       atol=GRAD_RTOL * np.abs(ref[name]).max(), rtol=0,
                                       err_msg=name)


def test_segmented_ring_matches_jax(world):
    """The segment ids rotate with their K/V block: packed sequences see
    only their own tokens.  (Its backward is the plain ring's, checked
    above: the ids carry no gradient.)"""
    ref = world["ref"]["seg"]
    for res in _cases(world, "seg_sp4"):
        np.testing.assert_allclose(res["out"].numpy(), _slice(ref, res).numpy(),
                                   atol=RING_ATOL, rtol=0)


def test_collectives_forward_and_backward(world):
    """ppermute's backward runs the inverse shift; copy_to_axis sums the
    gradient over tp, reduce_from_axis passes it through (not tp x it);
    the gather's backward keeps this rank's slice."""
    for res in _cases(world, "collectives"):
        i, r = res["coords"]["sp"], res["coords"]["tp"]
        y, dx = res["ppermute"]
        assert torch.equal(y, torch.full((3,), float((i - 1) % 2 + 1)))
        assert torch.equal(dx, torch.full((3,), float((i + 1) % 2 + 1)))
        assert torch.equal(res["copy_grad"], torch.full((2,), 3.0))
        assert torch.equal(res["reduce_grad"], torch.full((2,), float(r + 1)))
        gathered, dc = res["gather"]
        assert torch.equal(gathered, torch.tensor([1.0, 1.0, 2.0, 2.0]))
        assert torch.equal(dc, torch.tensor([1.0, 2.0]) + 2 * r)


def test_tp2_sharded_forward_matches_unsharded_and_jax(world):
    ref = world["ref"]["logits"]
    for res in _cases(world, "tp2_forward"):
        assert res["sliced_heads"] == 2  # 4 query heads over tp=2
        want = _slice(ref, {"plan": dict(dp=4, tp=2), "coords": res["coords"]},
                      ("dp", None, None)).numpy()
        scale = np.abs(want).max()
        np.testing.assert_allclose(res["sharded"].numpy(), res["unsharded"].numpy(),
                                   atol=LOGIT_RTOL_PORT * scale, rtol=0)
        np.testing.assert_allclose(res["sharded"].numpy(), want,
                                   atol=LOGIT_RTOL_JAX * scale, rtol=0)
