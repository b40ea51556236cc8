"""Dtype policies and the selective activation-checkpointing mask."""
