"""Tokens of every step of the window over the window's length."""


def read(rec):
    return sum(u["tokens"] for u in rec.units) / rec.window_s
