"""Tensor ops: norms, rotary, attention, KV quantization, paged decode."""
