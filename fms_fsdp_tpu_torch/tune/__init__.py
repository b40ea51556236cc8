"""Kernel tile resolution (static defaults; the tuner waits)."""
