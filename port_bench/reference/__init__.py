"""The benchmark's plain reference: plain PyTorch and numpy, written for
the comparison that decides `correct`. It imports nothing of the program
and derives every table and packed weight again from the raw inputs."""
