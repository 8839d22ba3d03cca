"""Milliseconds of one operator product, host clock around back-to-back
products, synchronised, untraced."""


def read(r):
    s = r.spans.get("matvec_untraced")
    if s is None or not r.on_card:  # a time off the card is no device metric
        return None
    return s * 1e3
