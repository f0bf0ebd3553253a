"""Host utilities of the port."""
