"""Milliseconds of one transpose product y = Aᵀ u of the operator, host
clock around back-to-back products, synchronised, untraced. None where the
configuration runs no transpose product."""


def read(r):
    s = r.spans.get("adjoint_untraced")
    if s is None or not r.on_card:  # a time off the card is no device metric
        return None
    return s * 1e3
