"""Wire protocols of the port (tpu_std)."""
