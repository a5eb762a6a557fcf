"""File formats the port reads and writes."""
