"""Model configs, init and the cached generation path (Llama)."""
