"""The dummy token stream and the host-to-card batch feed."""
