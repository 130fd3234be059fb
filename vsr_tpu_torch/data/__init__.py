"""Datasets, transforms and the batch loader of the training path."""
