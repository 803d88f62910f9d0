"""Training of the port's models (port of ``repro/training``)."""
from repro_torch.training.optimizer import adamw_init, adamw_update, cosine_lr  # noqa: F401
from repro_torch.training.train_step import loss_fn, make_train_step  # noqa: F401
