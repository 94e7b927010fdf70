from .convert import from_jax_variables
from .logging import seed_all_rng, setup_logger
from .params import count_parameters, label_params_for_optimizer
from .pretrained import load_pretrained
from .saver import Saver
from .summaries import SummaryWriter
