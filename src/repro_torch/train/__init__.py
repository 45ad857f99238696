"""Training: optimizer, gradient compression, trainer."""
from .optimizer import adamw_init, adamw_update, clip_by_global_norm, cosine_lr
from .trainer import TrainConfig, Trainer, init_opt_state, make_train_step
