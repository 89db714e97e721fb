"""Online serving of the port."""
