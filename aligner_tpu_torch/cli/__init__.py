"""Command-line interfaces of the port: search."""
