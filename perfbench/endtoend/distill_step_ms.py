"""The window's milliseconds over the distillation steps it completed,
batch fetching included (host clock; the window ends when the card has
finished its last step)."""


def read(window):
    return window.seconds * 1e3 / window.requests
