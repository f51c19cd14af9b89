"""Command-line tools of the port, each run as a module (counterparts of
the repository's tools/ scripts)."""
