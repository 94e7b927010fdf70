from .optimizer import (build_lr_schedule, build_optimizer, build_stereo_optimizer,
                        cosine_annealing_schedule, set_lr)
from .state import TrainState
from .steps import (check_weather, compute_loss, ingest_batch, init_eval_accum,
                    make_eval_step, make_stereo_train_step, make_train_step, stereo_loss)
from .checkpoints import CheckpointManager
from .trainer import Trainer
from .trainer_stereo import StereoTrainer
