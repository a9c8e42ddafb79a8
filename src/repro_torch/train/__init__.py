"""Training: the train state and the train step."""
