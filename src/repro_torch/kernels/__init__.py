"""Hand-written CUDA kernels of the port: the router's two (``linucb_score``,
``linucb_step``) and the served models' three (``flash_attention``,
``decode_attention``, ``ssd_scan``).

Each kernel package holds ``ref.py`` (the plain PyTorch version),
``kernel.py`` (the launch of the compiled CUDA kernel) and ``ops.py`` (the
wrapper: on a CPU tensor it runs ``ref.py``, on a CUDA tensor it checks
its operands and launches the kernel, counting launches). The CUDA
sources are in ``csrc/``; ``build.py`` compiles them at first use.
"""
