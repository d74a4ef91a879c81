"""Applications of the port: the CLI and its shared plumbing."""
