"""Config helpers: the model-variant table."""
