"""ITA integer softmax (plain version + Hopper kernel)."""
