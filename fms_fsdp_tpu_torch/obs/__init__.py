"""Observability: the metric registry."""
