"""Device kernels: vectorized batch DP over pair batches, one plain-XLA
(jax.numpy / lax) implementation per algorithm.  GenASM runs on the NW
kernel (see nw_xla)."""
