"""Pure-Python utilities of the port: its own copies of the reference's
metrics registry and trace-context helpers."""
