"""Paged decode attention over float and int8 block pools (plain versions + Hopper kernel)."""
