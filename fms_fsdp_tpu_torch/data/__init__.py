"""The streaming loader (a copy of the JAX package's data layer, see
loader.py), the dummy token stream and the host-to-card batch feed."""
