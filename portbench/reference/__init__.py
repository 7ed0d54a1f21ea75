"""The plain reference: PyTorch and NumPy only. It imports nothing of the
port, of the JAX package or of JAX, and takes nothing that the port made."""
