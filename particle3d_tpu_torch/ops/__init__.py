"""Force operations and the K1 kernel wrapper."""
