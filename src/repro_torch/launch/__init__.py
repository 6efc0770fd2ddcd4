"""Entry points of the port that run a pipeline behind a server."""
