"""Model server: ``python -m githubrepostorag_tpu_torch.serving``; port of
``githubrepostorag_tpu/serving/__main__.py`` for one NVIDIA GPU.

Loads a local HuggingFace Qwen2 or Qwen2-MoE checkpoint
(``MODEL_WEIGHTS_PATH``: a ``config.json``, ``*.safetensors`` shards and
the tokenizer files; ``MOE_CAPACITY_FACTOR`` sets an MoE model's expert
capacity, ``MOE_DROP_STATS=1`` counts its dropped assignments), builds
the paged engine from the settings (``config.py``: ``MAX_NUM_SEQS``,
``KV_NUM_PAGES``, ``KV_PAGE_SIZE``, ``PREFILL_CHUNK``, ``CONTEXT_WINDOW``,
``PREFILL_TOKEN_BUDGET``, ``KV_QUANT``, ``QUANTIZE_WEIGHTS``, ...), warms it
up and serves the OpenAI-compatible surface (/v1/chat/completions,
/v1/completions, /v1/models, /health, /debug/*) until SIGTERM or
SIGINT.  Worker and ingest pods point ``QWEN_ENDPOINT`` here with
``LLM_BACKEND=http``.

    python -m githubrepostorag_tpu_torch.serving --port 8000               # on the card
    python -m githubrepostorag_tpu_torch.serving --device cpu --port 8000  # plain path

The server runs on the card unless ``--device cpu`` asks for the CPU.  It
serves the engine's modes from their settings: n-gram speculation
(``SPEC_NGRAM_K``), its on-device burst (``SPEC_BURST_ITERS``), the fused
step (``FUSED_STEP`` with ``PREFILL_TOKEN_BUDGET``), draft-model
speculation (``SPEC_DRAFT_MODEL``: a second checkpoint dir sharing the
target's tokenizer, loaded unquantized; ``SPEC_K``, ``SPEC_ITERS``,
``SPEC_ACCEPT_FLOOR``, ``SPEC_DEADLINE_MARGIN_S``), the host KV tier
(``KV_TIER``, ``KV_HOST_POOL_PAGES``, ``KV_MIGRATE_BURST``) and
preempt-to-host (``PREEMPT``, ``PREEMPT_HEADROOM_PAGES``,
``PRIORITY_PROTECTED_CLASS``), over bf16, int8 or int4 pages
(``KV_QUANT``), and the observability planes' /debug/slo, /debug/fleet,
/debug/hbm and /debug/timeline.

``MESH_SHAPE=dp:N`` serves N engine replicas behind ``MultiAsyncEngine``'s
prefix-affinity router (``serving/multi_engine.py``): the weights load
once and every replica is ``build_engine``'s engine over that one tree,
on its ``dp_devices`` device (all on one card share it), warmed up in
turn.  ``FLEET_SPARES`` trailing replicas (clamped to leave one active)
start as warm spares; ``DISAGG=on`` splits a tiered fleet into prefill
and decode replicas; ``CTRL=on`` with more than one replica runs the
self-healing ``FleetController`` (``CTRL_SNAPSHOT_DIR`` set: a spare
restores the latest index snapshot into the store before it activates).
``POST /debug/fleet/drain`` and ``/activate`` act on the fleet.  Every
replica launches onto the card's default stream (``multi_engine.py``).

``MESH_SHAPE`` with ``tp``, ``sp`` or ``ep`` axes (or, unset, inside a
world of several ranks: ``plan_for_devices(world, role="serve")``'s tp)
serves one model over a ``torch.distributed`` world, one process a card,
launched with JAX's environment contract (``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``; ``parallel/distributed.py``).
Every rank loads the checkpoint unfused and keeps its slices
(``Engine(mesh=)``); ``SP_PREFILL_THRESHOLD`` (derived when unset,
``engine.derive_sp_prefill_threshold``) routes long prompts to the ring
prefill over sp.  Rank 0 serves HTTP and runs ``AsyncEngine`` as the
lockstep leader; the other ranks follow it (``serving/spmd.py``) and exit
when it stops.  ``pp``, ``ep`` over a dense checkpoint, ``dp`` beside
another axis and the engine modes a mesh does not serve yet (ROADMAP queue
1 item 8.6) exit with a message.

    MESH_SHAPE=dp:2 python -m githubrepostorag_tpu_torch.serving --port 8000
    MESH_SHAPE=dp:3 FLEET_SPARES=1 CTRL=on python -m githubrepostorag_tpu_torch.serving
    MESH_SHAPE=dp:2 DISAGG=on KV_TIER=on python -m githubrepostorag_tpu_torch.serving
    # one process a card, ranks 0 and 1:
    MESH_SHAPE=tp:2 JAX_COORDINATOR_ADDRESS=127.0.0.1:29500 JAX_NUM_PROCESSES=2 \
        JAX_PROCESS_ID=0 python -m githubrepostorag_tpu_torch.serving --port 8000
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import signal

import torch

from githubrepostorag_tpu_torch.config import Settings, get_settings
from githubrepostorag_tpu_torch.device import resolve_device
from githubrepostorag_tpu_torch.parallel.mesh import MeshPlan, plan_for_devices, plan_from_string
from githubrepostorag_tpu_torch.serving.engine import Engine, derive_sp_prefill_threshold

logger = logging.getLogger("githubrepostorag_tpu_torch.serving")

_SPEC_EXCLUSIVE = ("SPEC_DRAFT_MODEL and SPEC_NGRAM_K are mutually exclusive: "
                   "a serving pod runs one speculation strategy")


def check_served(s: Settings, world: int | None = 1) -> MeshPlan:
    """The mesh plan to serve over a world of ``world`` ranks: ``MESH_SHAPE``,
    or, unset, ``plan_for_devices(world, role="serve")``'s tp (the JAX
    server's rule; the heads are checked once the config is read).  Exits
    with a message for settings the server cannot serve, or that contradict
    each other; ``world`` None checks only what fails on any world."""
    if s.spec_draft_model and s.spec_ngram_k:
        raise SystemExit(_SPEC_EXCLUSIVE)
    if not s.mesh_shape:
        return MeshPlan(tp=plan_for_devices(world or 1, role="serve").tp)
    try:
        plan = plan_from_string(s.mesh_shape)
    except ValueError as exc:
        raise SystemExit(str(exc)) from None
    if plan.pp > 1:
        raise SystemExit(f"MESH_SHAPE={s.mesh_shape!r}: serving supports tp/sp/ep/dp axes — "
                         "pp is a training-side axis (training/pipeline.py)")
    spread = plan.n_devices // plan.dp
    if plan.dp > 1 and spread > 1:
        raise SystemExit(f"MESH_SHAPE={s.mesh_shape!r}: dp replicas of a tp / sp / ep mesh "
                         "are ROADMAP.md queue 1 item 8.6; serve dp or the other axes")
    if world is not None and spread > 1 and spread != world:
        raise SystemExit(f"MESH_SHAPE={s.mesh_shape!r} needs {spread} ranks, the world has "
                         f"{world}: start one process a card with JAX_COORDINATOR_ADDRESS, "
                         "JAX_NUM_PROCESSES and JAX_PROCESS_ID")
    return plan


def check_model(s: Settings, plan: MeshPlan, cfg) -> MeshPlan:
    """The plan against the checkpoint's config: ep needs experts (JAX's
    message); an unset MESH_SHAPE's tp shrinks until it divides both head
    counts, as ``plan_for_devices`` would with them."""
    if plan.ep > 1 and cfg.num_experts == 0:
        raise SystemExit(
            f"MESH_SHAPE={s.mesh_shape!r}: ep shards the expert stacks of an MoE "
            f"checkpoint, but {s.model_weights_path} is a dense model (num_experts=0) — "
            "ep chips would replicate its work; use tp/sp instead")
    if not s.mesh_shape:
        return MeshPlan(tp=plan_for_devices(plan.tp, num_heads=cfg.num_heads,
                                            num_kv_heads=cfg.num_kv_heads, role="serve").tp)
    return plan


def load_draft(s: Settings, device) -> tuple[dict | None, object | None]:
    """The draft model of ``SPEC_DRAFT_MODEL`` (params, config), or (None,
    None) when unset.  It loads unquantized and unfused (the engine fuses
    it) and must share the target's tokenizer: the engine refuses another
    vocabulary size."""
    if not s.spec_draft_model:
        return None, None
    if s.spec_ngram_k:
        raise SystemExit(_SPEC_EXCLUSIVE)
    from githubrepostorag_tpu_torch.models.hf_loader import load_qwen2

    logger.info("loading draft model from %s", s.spec_draft_model)
    return load_qwen2(s.spec_draft_model, dtype=torch.bfloat16, device=device,
                      moe_capacity_factor=s.moe_capacity_factor)


def build_engine(s: Settings, params: dict, cfg, device, draft=None, mesh=None) -> Engine:
    """The engine the settings describe (the JAX server's keywords, so a
    mode the port does not run is refused by ``Engine``), with the draft
    model of ``SPEC_DRAFT_MODEL``: ``draft`` (params, config) when the
    caller loaded it, else loaded here.  ``params`` is shared, never
    copied: a fused tree passes through ``Engine``'s fusing as it is.  On
    a ``mesh`` (this rank's) the tree is the whole unfused one, which the
    engine slices, and the sp threshold is derived from the settings."""
    draft_params, draft_cfg = draft if draft is not None else load_draft(s, device)
    sp_threshold = derive_sp_prefill_threshold(
        sp=mesh.shape["sp"] if mesh is not None else 1, explicit=s.sp_prefill_threshold,
        env_set=s.sp_prefill_threshold_set, prefill_chunk=s.prefill_chunk,
        max_seq_len=s.context_window)
    return Engine(
        params, cfg,
        max_num_seqs=s.max_num_seqs,
        num_pages=s.kv_num_pages,
        page_size=s.kv_page_size,
        max_seq_len=s.context_window,
        prefill_chunk=s.prefill_chunk,
        prefill_widths=s.prefill_widths,
        prefill_token_budget=s.prefill_token_budget or None,
        kv_quant=s.kv_quant,
        prefix_caching=s.prefix_caching,
        kv_tier=s.kv_tier,
        kv_host_pool_pages=s.kv_host_pool_pages,
        kv_migrate_burst=s.kv_migrate_burst,
        prefill_priority=s.prefill_priority,
        mesh=mesh,
        sp_prefill_threshold=sp_threshold,
        sp_ring_pack=s.sp_ring_pack,
        sp_ring_buckets=s.sp_ring_buckets,
        spec_ngram_k=s.spec_ngram_k,
        spec_burst_iters=s.spec_burst_iters,
        fused_step=s.fused_step,
        draft_params=draft_params,
        draft_cfg=draft_cfg,
        spec_k=s.spec_k,
        spec_iters=s.spec_iters,
        spec_accept_floor=s.spec_accept_floor,
        spec_deadline_margin_s=s.spec_deadline_margin_s,
        preempt=s.preempt,
        preempt_headroom_pages=s.preempt_headroom_pages,
        default_priority=s.priority_default_class,
        protected_priority=s.priority_protected_class,
        device=device,
    )


def build_serving_engine(s: Settings, params: dict, cfg, device, dp: int = 1):
    """What the server serves: one warmed-up engine behind ``AsyncEngine``
    for dp = 1; for dp > 1, ``dp`` warmed-up replicas over the one
    ``params`` tree behind ``MultiAsyncEngine``, each on its
    ``dp_devices`` device (every replica on one card launches onto its
    default stream), the last ``FLEET_SPARES`` of them (clamped to leave
    one active) warm spares."""
    from githubrepostorag_tpu_torch.serving.async_engine import AsyncEngine

    if dp <= 1:
        engine = build_engine(s, params, cfg, device)
        logger.info("warming up the engine (kernel builds on the card)")
        engine.warmup()
        return AsyncEngine(engine)
    from githubrepostorag_tpu_torch.models.quant import fuse_projections
    from githubrepostorag_tpu_torch.serving.multi_engine import MultiAsyncEngine, dp_devices

    draft_params, draft_cfg = load_draft(s, device)
    if draft_params is not None:
        # fused once here, so every replica shares one draft tree too
        draft_params = fuse_projections(draft_params, in_place=True)
    # the replicas share the weights' device (one tree, no copies): a fleet
    # across cards needs a tree on each, which comes with ROADMAP queue 1
    # item 8.5
    engines = []
    for i, dev in enumerate(dp_devices(dp, [device])):
        logger.info("building and warming up engine replica %d/%d on %s", i + 1, dp, dev)
        engine = build_engine(s, params, cfg, dev, draft=(draft_params, draft_cfg))
        engine.warmup()
        engines.append(engine)
    spares = max(0, min(s.fleet_spares, dp - 1))
    if spares:
        logger.info("fleet: %d active + %d warm spare replica(s)", dp - spares, spares)
    return MultiAsyncEngine(engines, spares=spares)


def build_controller(s: Settings, fleet):
    """The self-healing controller over ``fleet`` when ``CTRL=on`` and the
    fleet has more than one replica (a single replica has no spare to fail
    over to), else None.  With ``CTRL_SNAPSHOT_DIR`` set, a spare restores
    the latest index snapshot into the store before it activates."""
    from githubrepostorag_tpu_torch.serving.multi_engine import MultiAsyncEngine

    if s.ctrl != "on" or not isinstance(fleet, MultiAsyncEngine):
        return None
    from githubrepostorag_tpu_torch.serving.controller import FleetController

    restore = None
    if s.ctrl_snapshot_dir:
        from githubrepostorag_tpu_torch.retrieval.snapshot import restore_for_activation
        from githubrepostorag_tpu_torch.store.factory import get_store

        def restore():
            return restore_for_activation(s.ctrl_snapshot_dir, get_store())
    return FleetController(fleet, restore=restore)


async def serve(host: str, port: int, device: str | None = None) -> None:
    from githubrepostorag_tpu_torch.models.hf_loader import config_from_hf, load_qwen2
    from githubrepostorag_tpu_torch.parallel import make_mesh, maybe_initialize_distributed
    from githubrepostorag_tpu_torch.serving.openai_api import OpenAIServer
    from githubrepostorag_tpu_torch.serving.tokenizer import make_tokenizer

    s = get_settings()
    check_served(s, None)  # settings that fail on any world, before joining one
    dev = resolve_device(device)
    world = torch.distributed.get_world_size() if maybe_initialize_distributed(dev) else 1
    plan = check_served(s, world)
    if not s.model_weights_path:
        raise SystemExit("model server requires MODEL_WEIGHTS_PATH (a local HF checkpoint dir)")
    with open(f"{s.model_weights_path}/config.json") as fh:
        plan = check_model(s, plan, config_from_hf(json.load(fh), s.moe_capacity_factor))
    spread = plan.n_devices > plan.dp
    mesh = None
    if spread:
        from githubrepostorag_tpu_torch.serving import spmd

        mesh = make_mesh(plan)
        control = spmd.control_group()
        rank = torch.distributed.get_rank()
    # tokenizer first: a broken tokenizer config must fail fast, not after
    # the weights load
    tokenizer = make_tokenizer(s.model_weights_path)
    logger.info("tokenizer: %s", type(tokenizer).__name__)
    logger.info("loading weights from %s onto %s%s", s.model_weights_path, dev,
                f" (int{s.quantize_weights} weight-only)" if s.quantize_weights else "")
    params, cfg = load_qwen2(s.model_weights_path, dtype=torch.bfloat16,
                             quantize=s.quantize_weights, fuse=not spread, device=dev,
                             moe_capacity_factor=s.moe_capacity_factor)
    if spread:
        engine = build_engine(s, params, cfg, dev, mesh=mesh)
        del params
        logger.info("rank %d of mesh %s: warming up", rank, plan.shape())
        engine.warmup()
        if rank != 0:
            steps = spmd.follow(engine, control)
            logger.info("rank %d: rank 0 stopped after %d steps", rank, steps)
            return
        from githubrepostorag_tpu_torch.serving.async_engine import AsyncEngine

        engine = AsyncEngine(engine)
        engine.lockstep = leader = spmd.Leader(control)
    else:
        engine = build_serving_engine(s, params, cfg, dev, plan.dp)
        del params
    server = OpenAIServer(engine, tokenizer, model_name=s.qwen_model)
    bound = await server.start(host=host, port=port)
    controller = build_controller(s, engine)
    if controller is not None:
        await controller.start()
        logger.info("fleet controller up (tick %.2fs)", controller.tick_s)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    logger.info("model server up on %s:%d (device %s, %s)", host, bound, dev,
                f"mesh {plan.shape()}" if spread else
                f"{plan.dp} replica{'' if plan.dp == 1 else 's'}")
    failed = None
    try:
        while not stop.is_set():
            # a mesh whose driver died (a peer raised) takes the world down
            if spread and engine.driver_error is not None:
                failed = engine.driver_error
                break
            try:
                await asyncio.wait_for(stop.wait(), timeout=0.5)
            except asyncio.TimeoutError:
                pass
    finally:
        if controller is not None:
            controller.stop()
        await server.stop()
        if spread:
            leader.close()
        logger.info("model server stopped")
    if failed is not None:
        raise SystemExit(f"the mesh's engine driver failed: {failed}")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="OpenAI-compatible model server (PyTorch/CUDA)")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu, which runs the plain PyTorch path")
    args = parser.parse_args(argv)
    logging.basicConfig(level=get_settings().log_level.upper(),
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    asyncio.run(serve(args.host, args.port, args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
