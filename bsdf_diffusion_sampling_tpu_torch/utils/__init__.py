"""Validation metrics, numpy oracles, analytic 1-D distributions and figure
exports."""
