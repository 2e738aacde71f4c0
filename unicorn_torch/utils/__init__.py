"""Host-side numpy helpers of the port (copies of the JAX package's, whose
modules import jax)."""
