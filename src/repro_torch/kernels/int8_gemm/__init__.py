"""W8A8 int8 GEMM with fused requantize epilogue (plain version + Hopper kernel)."""
