from .optimizer import build_lr_schedule, build_optimizer, cosine_annealing_schedule, set_lr
from .state import TrainState
from .steps import compute_loss, ingest_batch, make_train_step
