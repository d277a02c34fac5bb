"""Step functions of the port (single device so far)."""
