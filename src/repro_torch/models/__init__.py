"""Model configs, parameter schemas, layers and the dense family's paged serving path."""
