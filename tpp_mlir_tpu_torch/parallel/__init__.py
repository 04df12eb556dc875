"""Training on one device: the MLP SGD step (`train.py`), the optimizer
step with gradient accumulation (`optim.py`) and the GPT step
(`gpt_train.py`), the port of the single-device core of
`tpp_mlir_tpu/parallel/`. Meshes beyond one device (dp, tp, ZeRO-1, the
vocab-parallel loss) are ROADMAP A11 and raise until then."""

from .gpt_train import make_gpt_train_step, next_token_loss
from .optim import (adamw, make_optim_step, make_optim_train_step, sgd,
                    tree_leaves)
from .train import make_train_step, mlp_init, mlp_params_from_numpy

__all__ = ["adamw", "make_gpt_train_step", "make_optim_step",
           "make_optim_train_step", "make_train_step", "mlp_init",
           "mlp_params_from_numpy", "next_token_loss", "sgd", "tree_leaves"]
