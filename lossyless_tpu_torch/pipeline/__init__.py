"""Experiment configuration and the featurizer training loop."""
