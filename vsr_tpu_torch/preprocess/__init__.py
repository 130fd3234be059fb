"""Preprocessing: serving-side intensity prep and k-space LR simulation,
and the offline ACDC / DSB15 pipeline with its cardiac cropping."""
