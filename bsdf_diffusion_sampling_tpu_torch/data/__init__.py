"""MCMC training data: the batched stretch-move ensemble and the banded
dataset generator."""
