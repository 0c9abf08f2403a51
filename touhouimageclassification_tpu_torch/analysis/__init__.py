"""Analysis tools of the port (the accuracy sweep)."""
