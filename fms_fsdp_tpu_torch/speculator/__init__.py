"""The speculator training entry point of the port
(``speculator/train_speculator.py``)."""
