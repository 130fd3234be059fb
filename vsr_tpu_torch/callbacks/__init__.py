"""Epoch callbacks of the trainers: the checkpoint monitor and the loggers."""
