"""The parallel layer: the port of `tpp_mlir_tpu/parallel/`.

SPMD over processes, one torch.distributed rank per device (`mesh.py`): a
`Mesh` of named axes over a `DeviceMesh`, specs (`P`) in place of
PartitionSpecs, `shard_tree`/`gather_tree` in place of `device_put`, and the
collectives with their true derivatives (`collectives.py`). Each rank runs
the JAX `shard_map` body on its shards with the port's kernels. The modes:

  dp  data parallel        runner.py   (batch sharding; the task grid)
  tp  tensor parallel      train.py, transformer.py, gpt_train.py, and the
                           tp decode in serving/engine.py (Megatron)
  pp  pipeline parallel    pipeline.py (GPipe microbatches over ring shifts)
  sp  sequence parallel    sequence.py (ring attention, rotating K/V)
  ep  expert parallel      moe.py      (switch MoE, two all-to-alls)

with the optimizer step, gradient accumulation and ZeRO-1 (`optim.py`) and
checkpoints (`checkpoint.py`). On one device every collective is the
identity and each step is the single-device step.
"""

from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .collectives import (all_to_all, gather_cols, mark_replicated,
                          pmax_stopgrad, ring_shift, row_parallel_psum)
from .gpt_train import (gpt_param_specs, make_gpt_train_step,
                        next_token_loss)
from .mesh import (Mesh, P, World, gather_tree, init_world, make_mesh,
                   shard_tree, spawn, task_grid_mesh)
from .moe import (make_moe_forward, moe_init, moe_param_specs,
                  moe_params_from_numpy, moe_reference)
from .optim import (ShardedOptim, adamw, make_optim_step,
                    make_optim_train_step, make_sharded_optim_step,
                    opt_state_shardings, sgd, tree_leaves)
from .pipeline import (make_pipeline_forward, make_pipeline_train_step,
                       pipeline_init, pipeline_param_specs,
                       pipeline_params_from_numpy, pipeline_reference)
from .runner import (data_parallel_run, dryrun_multichip, shard_run,
                     task_grid_run)
from .sequence import make_ring_attention, ring_attention_reference
from .train import (make_train_step, mlp_init, mlp_params_from_numpy,
                    param_specs)
from .transformer import (make_mha_forward, mha_param_specs, mha_params,
                          mha_params_from_numpy)

__all__ = [
    "Mesh", "P", "ShardedOptim", "World", "adamw", "all_to_all", "data_parallel_run",
    "dryrun_multichip", "gather_cols", "gather_tree", "gpt_param_specs",
    "init_world", "latest_step", "make_gpt_train_step", "make_mesh",
    "make_mha_forward", "make_moe_forward", "make_optim_step",
    "make_optim_train_step", "make_pipeline_forward",
    "make_pipeline_train_step", "make_ring_attention",
    "make_sharded_optim_step", "make_train_step", "mark_replicated",
    "mha_param_specs", "mha_params", "mha_params_from_numpy", "mlp_init",
    "mlp_params_from_numpy", "moe_init", "moe_param_specs",
    "moe_params_from_numpy", "moe_reference", "next_token_loss",
    "opt_state_shardings", "param_specs", "pipeline_init",
    "pipeline_param_specs", "pipeline_params_from_numpy",
    "pipeline_reference", "pmax_stopgrad", "restore_checkpoint",
    "ring_attention_reference", "ring_shift", "row_parallel_psum",
    "save_checkpoint", "sgd", "shard_run", "shard_tree", "spawn",
    "task_grid_mesh", "task_grid_run", "tree_leaves"]
