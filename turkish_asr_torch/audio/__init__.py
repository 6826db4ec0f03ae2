"""Host audio I/O (copied from the JAX package) and the log-mel front-end."""
