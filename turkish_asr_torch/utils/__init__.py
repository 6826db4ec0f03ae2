"""Weight bridge, device checks and shared error types."""
