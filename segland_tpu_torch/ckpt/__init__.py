from .convert import from_jax_variables, quant_from_jax, quant_to_jax
