"""ParetoBandit core in PyTorch: Algorithm 1 over a stack of router states."""
