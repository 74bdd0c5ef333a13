"""The plain reference that decides `correct`: plain PyTorch, no kernel,
nothing of the program and nothing of JAX."""
