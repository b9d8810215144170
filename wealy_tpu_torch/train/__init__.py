"""Training layer of the port: config, train state (f32 masters + AdamW),
the single-device train step (with GradCache ``grad_accum``), the loop and
``torch.save`` checkpoints; the counterpart of ``wealy_tpu.train``."""

from wealy_tpu_torch.train.config import Config, DataConfig, ModelConfig, PathConfig, TrainConfig
from wealy_tpu_torch.train.state import TrainState, create_train_state
from wealy_tpu_torch.train.step import make_eval_embed_step, make_train_step

__all__ = [
    "Config",
    "PathConfig",
    "DataConfig",
    "ModelConfig",
    "TrainConfig",
    "TrainState",
    "create_train_state",
    "make_train_step",
    "make_eval_embed_step",
]
