"""Config and CLI helpers, FLOPs accounting, the train loop."""
