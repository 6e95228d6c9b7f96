"""Training data: the batched stretch-move ensemble, the banded dataset
generator, and tabulated inverse-CDF sampling."""
