"""ParetoBandit in PyTorch: the router and its served portfolio on an
NVIDIA H100.

A second package beside the JAX reference (``repro``), mirroring its
layout: ``core/`` holds Algorithm 1 (types, PRNG, LinUCB, pacer, router,
backends, warm start, registry, simulator, evaluation harness, state
publication), ``models/`` and ``configs/`` the served models (dense and SSM),
``serving/`` the portfolio server and its gateway, and ``kernels/`` the
hand-written CUDA kernels with their plain PyTorch versions. Every ``RouterState`` leaf carries a leading state axis
``(S, ...)``: the JAX package ``vmap``s one state over seeds, the port
stacks them and its kernels take the stack.

Entry points run on the card unless the caller passes ``device="cpu"``;
without a GPU and without that argument they raise.
"""
