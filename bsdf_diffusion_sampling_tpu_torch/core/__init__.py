"""Configuration dataclasses and the torch.Generator discipline."""
