"""Serving-side preprocessing: intensity prep and k-space LR simulation."""
