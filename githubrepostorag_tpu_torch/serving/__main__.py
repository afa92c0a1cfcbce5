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
A ``tp``, ``sp``, ``ep`` or ``pp`` axis above 1 exits with a message
naming the ROADMAP.md item that brings it, and the engine refuses the
sequence-parallel ring's tuning (``SP_RING_*``) away from its default.

    MESH_SHAPE=dp:2 python -m githubrepostorag_tpu_torch.serving --port 8000
    MESH_SHAPE=dp:3 FLEET_SPARES=1 CTRL=on python -m githubrepostorag_tpu_torch.serving
    MESH_SHAPE=dp:2 DISAGG=on KV_TIER=on python -m githubrepostorag_tpu_torch.serving
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal

import torch

from githubrepostorag_tpu_torch.config import Settings, get_settings
from githubrepostorag_tpu_torch.device import resolve_device
from githubrepostorag_tpu_torch.parallel.mesh import plan_from_string
from githubrepostorag_tpu_torch.serving.engine import Engine

logger = logging.getLogger("githubrepostorag_tpu_torch.serving")

_SPEC_EXCLUSIVE = ("SPEC_DRAFT_MODEL and SPEC_NGRAM_K are mutually exclusive: "
                   "a serving pod runs one speculation strategy")


def check_served(s: Settings) -> int:
    """The number of dp replicas to serve; exits with a message for
    settings the port's server cannot serve, or that contradict each
    other."""
    try:
        axes = plan_from_string(s.mesh_shape).shape()
    except ValueError as exc:
        raise SystemExit(str(exc)) from None
    others = {name: n for name, n in axes.items() if name != "dp" and n > 1}
    if others:
        raise SystemExit(
            f"MESH_SHAPE is set with {others}, but the torch port serves dp replicas only "
            "yet; ROADMAP.md queue 1 item 8 (parallel layers: tp / sp / ep / pp meshes) "
            "brings them")
    if s.spec_draft_model and s.spec_ngram_k:
        raise SystemExit(_SPEC_EXCLUSIVE)
    return axes["dp"]


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


def build_engine(s: Settings, params: dict, cfg, device, draft=None) -> Engine:
    """The engine the settings describe (the JAX server's keywords, so a
    mode the port does not run is refused by ``Engine``), with the draft
    model of ``SPEC_DRAFT_MODEL``: ``draft`` (params, config) when the
    caller loaded it, else loaded here.  ``params`` is shared, never
    copied: a fused tree passes through ``Engine``'s fusing as it is."""
    draft_params, draft_cfg = draft if draft is not None else load_draft(s, device)
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
    # item 8
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
    from githubrepostorag_tpu_torch.models.hf_loader import load_qwen2
    from githubrepostorag_tpu_torch.serving.openai_api import OpenAIServer
    from githubrepostorag_tpu_torch.serving.tokenizer import make_tokenizer

    s = get_settings()
    dp = check_served(s)
    if not s.model_weights_path:
        raise SystemExit("model server requires MODEL_WEIGHTS_PATH (a local HF checkpoint dir)")
    dev = resolve_device(device)
    # tokenizer first: a broken tokenizer config must fail fast, not after
    # the weights load
    tokenizer = make_tokenizer(s.model_weights_path)
    logger.info("tokenizer: %s", type(tokenizer).__name__)
    logger.info("loading weights from %s onto %s%s", s.model_weights_path, dev,
                f" (int{s.quantize_weights} weight-only)" if s.quantize_weights else "")
    params, cfg = load_qwen2(s.model_weights_path, dtype=torch.bfloat16,
                             quantize=s.quantize_weights, fuse=True, device=dev,
                             moe_capacity_factor=s.moe_capacity_factor)
    engine = build_serving_engine(s, params, cfg, dev, dp)
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
    logger.info("model server up on %s:%d (device %s, %d replica%s)", host, bound, dev, dp,
                "" if dp == 1 else "s")
    try:
        await stop.wait()  # serve until the pod is stopped
    finally:
        if controller is not None:
            controller.stop()
        await server.stop()
        logger.info("model server stopped")


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
