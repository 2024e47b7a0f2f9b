from repro_torch.train.optimizer import OptConfig, adamw_update, init_opt_state  # noqa: F401
from repro_torch.train.train_step import TrainState, make_train_step  # noqa: F401
