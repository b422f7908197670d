"""The parallel layer over ``torch.distributed``: meshes of process groups,
ring and Ulysses attention, head-parallel attention and the strategy facade,
context- and head-sharded decode, the pipelined DiT, and the DiT's training
layouts: the step sharded over data × seq × model and the fully-sharded
(FSDP) parameters.

Counterpart of ``lowbit_quant_fa2_paddle_tpu/parallel/``. Where JAX runs one
program over global arrays (``shard_map``), each rank here runs its own
process on its local shard and exchanges through ``parallel/transport.py``:
on device over NCCL, or through host memory over gloo (ranks that share one
card). The ``make_*`` functions return callables on local shards.
"""

from lowbit_quant_fa2_paddle_tpu_torch.parallel.dryrun import (
    param_shardings,
    run_training_step_dryrun,
    sharded_sgd_train_step,
)
from lowbit_quant_fa2_paddle_tpu_torch.parallel.mesh import make_mesh
from lowbit_quant_fa2_paddle_tpu_torch.parallel.ring import make_ring_attention
from lowbit_quant_fa2_paddle_tpu_torch.parallel.serving import (
    make_context_sharded_decode,
    make_head_sharded_decode,
)
from lowbit_quant_fa2_paddle_tpu_torch.parallel.sharded import fsdp_shardings
from lowbit_quant_fa2_paddle_tpu_torch.parallel.ulysses import make_ulysses_attention

__all__ = [
    "make_mesh",
    "make_ring_attention",
    "make_ulysses_attention",
    "make_context_sharded_decode",
    "make_head_sharded_decode",
    "fsdp_shardings",
    "param_shardings",
    "sharded_sgd_train_step",
    "run_training_step_dryrun",
]
