"""Tools of the port that lie on no path of the CLI (``tools/`` of the
repository holds the JAX package's)."""
