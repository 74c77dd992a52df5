"""Serving error types."""


class ClientError(ValueError):
    """A request that cannot be served because of the CLIENT's input
    (bad speaker combination, malformed conditioning, ...). HTTP layers
    map this to 400; any other exception is a server fault (500)."""


def check_ids(ids, count: int, what: str) -> None:
    """Raise :class:`ClientError` unless every id lies in [0, count).

    The port checks speaker and gc ids on the host before they index a
    table: on the card an index out of range is a device-side assert that
    leaves the process's CUDA context unusable (JAX's ``jnp.take`` serves
    NaN rows instead)."""
    for i in ids:
        if not 0 <= int(i) < count:
            raise ClientError(f"{what} {int(i)} out of range [0, {count})")
