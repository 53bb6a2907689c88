"""Frames completed over the window's seconds (host clock)."""


def read(window):
    return window.requests / window.seconds
