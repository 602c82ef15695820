"""The port's own copies of the observability pieces its engines need."""
