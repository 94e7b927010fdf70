from .convert import from_jax_variables
from .params import label_params_for_optimizer
