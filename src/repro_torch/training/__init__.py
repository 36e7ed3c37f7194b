"""Training on one device: AdamW with a warmup + cosine schedule, the train
step (microbatched gradient accumulation) and loop."""
from repro_torch.training.optimizer import adamw_init, adamw_update, global_norm, lr_at  # noqa: F401
from repro_torch.training.trainer import init_train_state, make_train_step, train_loop  # noqa: F401
