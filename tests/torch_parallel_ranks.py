"""The gloo ranks of tests/test_torch_parallel.py and test_torch_training.py.

Each test file runs one world of ``WORLD`` CPU processes (``run_world``),
forked from a forkserver that imported torch and the port once, so a world
starts in seconds on one core.  A rank joins through the port's
``maybe_initialize_distributed`` (JAX's environment contract, gloo, a
finite group timeout), runs every case of its file in the same order as
its peers (every ``make_mesh`` on every rank: groups are made
collectively), and saves what it computed to ``<out>/<rank>.pt``; the test
process compares that with JAX.  The reference values reach the ranks as
numpy arrays, and no rank imports jax (each checks it did not).
"""

from __future__ import annotations

import multiprocessing
import os
import sys
import time

import numpy as np
import torch
import torch.multiprocessing as torch_mp

from githubrepostorag_tpu_torch.models.convert import params_from_jax
from githubrepostorag_tpu_torch.models.qwen2 import Qwen2Config, forward_with_attend
from githubrepostorag_tpu_torch.parallel import (
    MeshPlan,
    make_mesh,
    make_ring_attend,
    maybe_initialize_distributed,
    qwen2_param_specs,
    shard_params,
)
from githubrepostorag_tpu_torch.parallel.collectives import (
    copy_to_axis,
    gather_from_axis,
    ppermute,
    reduce_from_axis,
)
from githubrepostorag_tpu_torch.parallel.sharding import shard_tensor, tree_map
from githubrepostorag_tpu_torch.training import (
    load_checkpoint,
    make_train_step,
    save_checkpoint,
    value_and_grad,
)
from githubrepostorag_tpu_torch.training.step import leaves

WORLD = 8
GROUP_TIMEOUT_S = 60.0  # a collective whose peers never come fails after this
DEADLINE_S = 180.0  # the whole world, from the first fork to the last exit
QKV_SPEC = ("dp", "sp", "tp", None)  # [B, S, heads, hd] over the mesh


def run_world(fn, args: tuple, nprocs: int = WORLD, deadline_s: float = DEADLINE_S) -> None:
    """Run ``fn(rank, *args)`` on ``nprocs`` processes and wait for all of
    them, at most ``deadline_s``: a rank that raised fails the call with its
    traceback, and a world still running at the deadline is killed and
    fails it (a deadlock fails instead of hanging)."""
    multiprocessing.get_context("forkserver").set_forkserver_preload(
        ["torch", "torch.distributed", "torch._dynamo", __name__])
    ctx = torch_mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                                   start_method="forkserver")
    end = time.monotonic() + deadline_s
    try:
        while not ctx.join(timeout=max(0.0, end - time.monotonic())):
            if time.monotonic() >= end:
                raise TimeoutError(f"the world of {nprocs} ranks did not end within "
                                   f"{deadline_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)


def _join(rank: int, addr: str) -> None:
    torch.set_num_threads(1)
    os.environ.update(JAX_COORDINATOR_ADDRESS=addr, JAX_NUM_PROCESSES=str(WORLD),
                      JAX_PROCESS_ID=str(rank))
    assert maybe_initialize_distributed(device="cpu", timeout_s=GROUP_TIMEOUT_S)


def _done(rank: int, out_dir: str, results: dict) -> None:
    results["jax_imported"] = any(m == "jax" or m.startswith("jax.") for m in sys.modules)
    torch.save(results, os.path.join(out_dir, f"{rank}.pt"))
    torch.distributed.destroy_process_group()


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x))


def random_tree(shapes, seed: int):
    """Seeded float32 weights for a tree of shapes (JAX's ``init_params``
    structure, read with ``jax.eval_shape``): normal(0, 0.02), biases too,
    and norm scales 1 + normal(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def fill(name, shape):
        if isinstance(shape, dict):
            return {k: fill(k, v) for k, v in shape.items()}
        base = 1.0 if name in ("ln1", "ln2", "norm") else 0.0
        scale = 0.1 if base else 0.02
        return (base + scale * rng.standard_normal(shape)).astype(np.float32)

    return fill("", shapes)


# ------------------------------------------------------------ parallel/ --


def _ring_case(mesh, qkv: dict, seg=None, grads: bool = True) -> dict:
    """Ring attention over this rank's shards of the global q, k, v (and
    segment ids); the local output and, for the global sum of squares, the
    local q / k / v gradients."""
    loc = {n: shard_tensor(_t(qkv[n]), mesh, QKV_SPEC).requires_grad_(grads)
           for n in ("q", "k", "v")}
    nq, nkv = qkv["q"].shape[2], qkv["k"].shape[2]
    attend = make_ring_attend(mesh, num_heads=nq, num_kv_heads=nkv, segmented=seg is not None)
    extra = () if seg is None else (shard_tensor(_t(seg), mesh, ("dp", "sp")),)
    out = attend(loc["q"], loc["k"], loc["v"], *extra)
    res = {"coords": mesh.coords, "plan": mesh.shape, "out": out.detach()}
    if grads:
        (out ** 2).sum().backward()
        res.update({f"d{n}": loc[n].grad for n in ("q", "k", "v")})
    return res


def _collectives_case(mesh) -> dict:
    """The four collectives' forward and backward on the full mesh: the
    ppermute shift over sp, the Megatron pair and the gather over tp."""
    sp, tp = mesh.group("sp"), mesh.group("tp")
    i, n = mesh.coords["sp"], mesh.shape["sp"]
    x = torch.full((3,), float(i + 1), requires_grad=True)
    y = ppermute(x, sp, [(j, (j + 1) % n) for j in range(n)])
    (y * (i + 1)).sum().backward()
    r = mesh.coords["tp"]
    a = torch.full((2,), float(r + 1), requires_grad=True)
    (copy_to_axis(a, tp) * (r + 1)).sum().backward()
    b = torch.full((2,), float(r + 1), requires_grad=True)
    (reduce_from_axis(b, tp) * (r + 1)).sum().backward()
    c = torch.full((2,), float(r + 1), requires_grad=True)
    gathered = gather_from_axis(c, tp, dim=0)
    (gathered * torch.arange(1.0, gathered.numel() + 1)).sum().backward()
    return {"coords": mesh.coords, "ppermute": (y.detach(), x.grad),
            "copy_grad": a.grad, "reduce_grad": b.grad, "gather": (gathered.detach(), c.grad)}


def parallel_world(rank: int, addr: str, refs: dict, out_dir: str) -> None:
    _join(rank, addr)
    res = {}
    sp4 = [make_mesh(MeshPlan(sp=4), devices=range(0, 4)),
           make_mesh(MeshPlan(sp=4), devices=range(4, 8))]
    if sp4[0] is not None:  # ranks 0-3: the plain ring and its gradients
        res["ring_sp4"] = _ring_case(sp4[0], refs["ring"], grads=False)
        res["ring_sp4_grads"] = _ring_case(sp4[0], refs["grad"])
    else:  # ranks 4-7 meanwhile: the segmented ring
        res["seg_sp4"] = _ring_case(sp4[1], refs["ring"], seg=refs["seg"], grads=False)
    full = make_mesh(MeshPlan(dp=2, tp=2, sp=2))
    res["ring_full"] = _ring_case(full, refs["ring"], grads=False)
    res["ring_full_grads"] = _ring_case(full, refs["grad"])
    res["collectives"] = _collectives_case(full)

    cfg = Qwen2Config.tiny()
    params = params_from_jax(refs["model"]["params"], cfg, device="cpu")
    ids = _t(refs["model"]["ids"])
    pos = torch.arange(ids.shape[1]).expand(ids.shape)
    tp2 = make_mesh(MeshPlan(dp=4, tp=2))
    rows = shard_tensor(ids, tp2, ("dp", None))
    sharded = shard_params(params, tp2, qwen2_param_specs(cfg, tp2))
    res["tp2_forward"] = {
        "coords": tp2.coords,
        "sharded": forward_with_attend(sharded, cfg, rows, pos[: len(rows)], mesh=tp2),
        "unsharded": forward_with_attend(params, cfg, rows, pos[: len(rows)]),
        "sliced_heads": sharded["layers"]["wq"].shape[-1] // cfg.head_dim,
    }
    _done(rank, out_dir, res)


# ------------------------------------------------------------ training/ --


def _step_case(cfg, mesh, params, batch, remat_grads: bool = False) -> dict:
    """One step from ``params`` (whole, numpy) on ``mesh``: the loss, this
    rank's gradients and its parameters after the AdamW update."""
    specs = qwen2_param_specs(cfg, mesh)
    local = shard_params(params_from_jax(params, cfg, device="cpu"), mesh, specs)
    tb = {k: _t(v) for k, v in batch.items()}
    loss, grads = value_and_grad(local, cfg, mesh, tb)
    res = {"coords": mesh.coords, "plan": mesh.shape, "loss": loss, "grads": grads}
    if remat_grads:
        res["grads_no_remat"] = value_and_grad(local, cfg, mesh, tb, remat=False)[1]
    step, opt = make_train_step(cfg, mesh)
    opt_state = opt(leaves(local))
    local, opt_state, step_loss = step(local, opt_state, tb)
    # the step updates in place: keep the parameters after this one
    res.update(step_loss=step_loss, params=tree_map(torch.clone, local), local=local, step=step,
               opt_state=opt_state, batch=tb, specs=specs)
    return res


def training_world(rank: int, addr: str, refs: dict, out_dir: str) -> None:
    _join(rank, addr)
    cfg = Qwen2Config.tiny()
    params, batch = refs["params"], refs["batch"]
    keep = ("coords", "plan", "loss", "grads", "grads_no_remat", "step_loss", "params")
    res = {}
    one = make_mesh(MeshPlan())
    if one is not None:  # rank 0 alone: the one-device plan, remat on and off
        r = _step_case(cfg, one, params, batch, remat_grads=True)
        res["single"] = {k: r[k] for k in keep if k in r}
    quarter = [make_mesh(MeshPlan(tp=4), devices=range(0, 4)),
               make_mesh(MeshPlan(sp=4), devices=range(4, 8))]
    for name, mesh in zip(("tp4", "sp4"), quarter):
        if mesh is not None:
            r = _step_case(cfg, mesh, params, batch)
            res[name] = {k: r[k] for k in keep if k in r}
    full = make_mesh(MeshPlan(dp=2, tp=2, sp=2))
    r = _step_case(cfg, full, params, batch, remat_grads=True)
    res["full"] = {k: r[k] for k in keep if k in r}
    local, opt_state, losses = r["local"], r["opt_state"], [float(r["step_loss"])]
    for _ in range(3):
        local, opt_state, loss = r["step"](local, opt_state, r["batch"])
        losses.append(float(loss))
    res["full"]["losses"] = losses

    path = os.path.join(out_dir, "ckpt")
    save_checkpoint(path, local, mesh=full, specs=r["specs"])
    template = shard_params(params_from_jax(params, cfg, device="cpu"), full, r["specs"])
    restored = load_checkpoint(path, template, mesh=full)
    res["checkpoint"] = {"coords": full.coords, "saved": local, "restored": restored}
    _done(rank, out_dir, res)
