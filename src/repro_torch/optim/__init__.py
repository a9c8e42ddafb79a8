"""Optimizer and learning-rate schedules of the training path."""
