"""Padding math shared by the data path and serving."""


def round_up(x: int, multiple: int) -> int:
    remainder = x % multiple
    return x if remainder == 0 else x + multiple - remainder
