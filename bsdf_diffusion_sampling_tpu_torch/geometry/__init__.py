"""Maps between the sampling domains and cartesian directions."""
