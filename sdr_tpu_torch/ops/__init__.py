"""Reference-contract signal ops of the port, on torch tensors."""
