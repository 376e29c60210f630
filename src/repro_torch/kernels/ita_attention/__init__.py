"""ITA fused int8 attention with an integer streaming softmax (plain
version + Hopper kernel)."""
