"""Examples of the port (the counterparts of the JAX package's ``examples/``)."""
