"""Step-indexed training data: the synthetic token stream and byte corpora."""
