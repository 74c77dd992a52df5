"""Serving error types."""


class ClientError(ValueError):
    """A request that cannot be served because of the CLIENT's input
    (bad speaker combination, malformed conditioning, ...). HTTP layers
    map this to 400; any other exception is a server fault (500)."""
