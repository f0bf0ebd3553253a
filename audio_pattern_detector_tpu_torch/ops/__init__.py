"""Device ops of the port: plain torch functions on tensors, plus kernel wrappers."""
