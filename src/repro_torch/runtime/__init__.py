"""Step functions of the port (prefill and decode)."""
