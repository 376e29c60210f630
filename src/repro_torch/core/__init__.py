"""Core integer arithmetic (quantization, integer activations) and device resolution."""
