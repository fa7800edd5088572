"""Host data plane of the port."""
