"""Reports over the port's run records (`report`)."""
