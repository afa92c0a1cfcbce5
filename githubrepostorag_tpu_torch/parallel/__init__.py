"""Mesh / sharding / collectives: the model-level distributed fabric; port of
``githubrepostorag_tpu/parallel/``.

  mesh.py           -- one rank's place in a grid over the logical axes
                       (dp, pp, tp, sp, ep), a process group per axis;
                       factorisation helpers.
  distributed.py    -- ``torch.distributed`` from JAX's environment contract.
  collectives.py    -- differentiable ppermute and the Megatron pair, which
                       JAX gets from ``lax`` and GSPMD.
  sharding.py       -- spec rules for the Qwen2 decoder and the BERT encoder
                       params (Megatron column/row TP) and the cut of a
                       rank's slices.
  ring_attention.py -- sequence-parallel causal GQA attention: K/V blocks
                       rotate around the ``sp`` ring into an online softmax.

JAX's ``compat.py`` (a ``shard_map`` version shim) has no counterpart: the
port calls its collectives itself.
"""

from githubrepostorag_tpu_torch.parallel.distributed import maybe_initialize_distributed
from githubrepostorag_tpu_torch.parallel.mesh import (
    AXIS_NAMES,
    Mesh,
    MeshPlan,
    make_mesh,
    plan_for_devices,
    plan_from_string,
)
from githubrepostorag_tpu_torch.parallel.ring_attention import make_ring_attend, ring_attention
from githubrepostorag_tpu_torch.parallel.sharding import (
    batch_spec,
    encoder_param_specs,
    qwen2_param_specs,
    shard_params,
)

__all__ = [
    "AXIS_NAMES",
    "maybe_initialize_distributed",
    "Mesh",
    "MeshPlan",
    "make_mesh",
    "plan_for_devices",
    "plan_from_string",
    "qwen2_param_specs",
    "encoder_param_specs",
    "shard_params",
    "batch_spec",
    "ring_attention",
    "make_ring_attend",
]
