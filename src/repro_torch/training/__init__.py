from repro_torch.training.train_step import TrainState, make_train_step, train_state_init  # noqa: F401
from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint  # noqa: F401
