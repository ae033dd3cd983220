"""One-card serving of the port."""
