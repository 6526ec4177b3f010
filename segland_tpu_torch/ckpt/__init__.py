from .convert import from_jax_variables, quant_from_jax, quant_to_jax
from .io import load_checkpoint, load_pth, save_checkpoint, save_params
