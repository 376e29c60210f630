"""PyTorch/CUDA port of the CHIMERA serving reproduction (``repro``).

Same layout as the JAX package (``configs/``, ``core/``, ``kernels/``,
``models/``, ``serve/``) so every module has an obvious counterpart; the
JAX package stays the reference and this package never imports it (nor
``jax``). Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper runs its plain PyTorch
version, on a CUDA tensor it launches the hand-written Hopper kernel.

This slice covers paged continuous-batching serving of the dense family:
``serve.LLMEngine(backend="paged")`` over float or int8 block pools.
"""
