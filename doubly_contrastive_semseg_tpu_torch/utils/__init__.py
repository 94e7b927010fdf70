from .convert import from_jax_variables
