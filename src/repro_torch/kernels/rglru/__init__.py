"""RG-LRU diagonal recurrence (plain versions + Hopper kernel)."""
