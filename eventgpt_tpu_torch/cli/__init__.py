"""See the package docstring of ``eventgpt_tpu_torch``."""
