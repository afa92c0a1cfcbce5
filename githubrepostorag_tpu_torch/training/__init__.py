"""Sharded training / fine-tuning over the mesh; port of
``githubrepostorag_tpu/training/``.

The train step shares the mesh, the sharding rules and ring attention with
serving (``parallel/``).  JAX's pipeline-parallel step
(``training/pipeline.py``: ``make_pp_train_step``, ``init_pp_train_state``,
``split_layers_for_pp``, ``merge_layers_from_pp``) is not ported yet
(ROADMAP.md queue 1 item 8.4).
"""

from githubrepostorag_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint
from githubrepostorag_tpu_torch.training.step import (
    TrainState,
    adamw,
    causal_lm_loss,
    init_train_state,
    make_train_step,
    value_and_grad,
)

__all__ = [
    "TrainState",
    "adamw",
    "causal_lm_loss",
    "init_train_state",
    "load_checkpoint",
    "make_train_step",
    "save_checkpoint",
    "value_and_grad",
]
